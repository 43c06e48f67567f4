// Scatter-pack MSB-first bit fields at their start bits into payload
// bytes, with the writer's 1-padding of the final partial byte.
//
// Replaces the TPU kernel repro/kernels/pack_bits/kernel.py:
// pack_bits_pallas, which tiles the *output* bits and, per tile, gathers
// the window of fields that can touch it (a host searchsorted) and sums
// their byte contributions by one-hot compares: no data-dependent writes,
// as the TPU wants.  The H100 has atomics on device memory, so here one
// thread per field ORs its bits into the one or two 32-bit words it
// spans.  Fields never overlap, so the result does not depend on the
// order of the atomics.  The stream is MSB-first within bytes and bytes
// are in stream order in memory: a field's bits are placed in a
// big-endian view of its word and byte-swapped before the OR (a byte
// swap distributes over OR).  One extra thread ORs the padding.
//
// What bounds it on the H100: bytes.  Each field is read once (int32
// code, int32 width, int64 start: 16 B) and the payload is written once;
// there are a few integer operations per field.  The caller zeroes the
// output words.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ unsigned bswap(unsigned x) {
  return __byte_perm(x, 0, 0x0123);
}

__global__ void __launch_bounds__(THREADS)
pack_bits_kernel(const int* __restrict__ codes,
                 const int* __restrict__ lengths,
                 const long long* __restrict__ starts, long long m,
                 long long total_bits, unsigned* __restrict__ words) {
  const long long i =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i > m) return;
  // thread m ORs the writer's 1-padding of the final partial byte
  const int len = i == m ? static_cast<int>((-total_bits) & 7) : lengths[i];
  if (len <= 0) return;
  const long long s = i == m ? total_bits : starts[i];
  const unsigned v = (i == m ? ~0u : static_cast<unsigned>(codes[i])) &
                     ((1u << len) - 1);
  const long long w = s >> 5;
  const int end = static_cast<int>(s & 31) + len;  // in 1..47
  if (end <= 32) {
    atomicOr(&words[w], bswap(v << (32 - end)));
  } else {
    atomicOr(&words[w], bswap(v >> (end - 32)));
    atomicOr(&words[w + 1], bswap(v << (64 - end)));
  }
}

}  // namespace

// codes, lengths: (m,) int32, widths in [0, 16]; starts: (m,) int64;
// words: ceil(ceil(total_bits / 8) / 4) uint32, zeroed.
REPRO_EXPORT int pack_bits_launch(const int* codes, const int* lengths,
                                  const long long* starts, long long m,
                                  long long total_bits, unsigned* words,
                                  void* stream) {
  const long long blocks = (m + 1 + THREADS - 1) / THREADS;
  pack_bits_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      codes, lengths, starts, m, total_bits, words);
  return static_cast<int>(cudaGetLastError());
}
