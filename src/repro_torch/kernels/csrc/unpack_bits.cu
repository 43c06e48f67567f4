// Speculative Huffman decode of an entropy payload from every bit offset:
// DC and AC unit words, and AC chain outcome words by pointer doubling.
//
// Replaces the TPU kernel repro/kernels/unpack_bits/kernel.py:
// unpack_bits_pallas.  Its word layouts are kept (kernels/unpack_bits/
// ref.py): unit words (ctrl + 2) << 6 | adv, outcome words value << 2 |
// kind.  What differs, for the H100:
//
// - one CTA per tile of tile_bits offsets stages tile_bits + 2048
//   offsets (a block that starts in the tile ends inside that window),
//   reading the payload bytes directly (no 16-bit window array) and
//   writing the three words only for its own tile, into flat arrays
//   indexed by bit offset: each offset is written once, by the CTA whose
//   tile holds it.  Unit words depend on the offset alone and every AC
//   chain starting in the tile ends inside the window, so the words do
//   not depend on the tile size;
// - a codeword is matched against the table's 16 canonical
//   (mincode, maxcode, valptr) bounds held in shared memory, as the TPU
//   kernel does, but the symbol is a shared-memory lookup, not a
//   256-wide one-hot sum;
// - the six pointer-doubling squarings over (next position, positions
//   covered) run in shared memory as int16 arrays, one level per
//   squaring, with __syncthreads() between; the descent to the unit
//   that crosses position 63 reads the saved levels.  At tile 2048 the
//   CTA holds 4096 offsets: 128 KB of dynamic shared memory.
//
// What bounds it on the H100: bytes.  It must read the payload and write
// 12 bytes per bit offset; the matching is about a hundred integer
// operations per offset and table.

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MARGIN_BITS = 2048;
constexpr int LEVELS = 7;  // pointer-doubling levels 0..6
constexpr int ZRL = 0xF0;
constexpr int MAX_CATEGORY = 15;

__device__ __forceinline__ unsigned window16(const unsigned char* pay,
                                             long long nbytes, long long p) {
  const long long k = p >> 3;
  unsigned w = 0;
  for (int j = 0; j < 3; ++j)
    w = (w << 8) | (k + j < nbytes ? pay[k + j] : 0xFFu);
  return (w >> (8 - (p & 7))) & 0xFFFFu;
}

__device__ __forceinline__ int unit_word(unsigned w16, long long p,
                                         long long nbits, const int* prm,
                                         const int* sym) {
  int length = 0, sidx = 0;
#pragma unroll
  for (int L = 1; L <= 16; ++L) {
    const int c = static_cast<int>(w16 >> (16 - L));
    const int mn = prm[L - 1], mx = prm[16 + L - 1];
    if (mx >= 0 && c >= mn && c <= mx) {
      length = L;
      sidx = prm[32 + L - 1] + c - mn;
    }
  }
  const int s = length ? sym[sidx] : 0;
  const int size = s > MAX_CATEGORY ? (s & 0xF) : s;
  int adv = length + size;
  int ctrl = length ? s : -1;
  if (p + adv > nbits) ctrl = -2;
  if (ctrl < 0) adv = 0;
  return ((ctrl + 2) << 6) | adv;
}

__global__ void __launch_bounds__(THREADS)
unpack_bits_kernel(const unsigned char* __restrict__ pay, long long nbytes,
                   const int* __restrict__ params,
                   const int* __restrict__ syms, int* __restrict__ dcw,
                   int* __restrict__ acw, int* __restrict__ outc,
                   int tile_bits) {
  extern __shared__ int smem[];
  const int window = tile_bits + MARGIN_BITS;
  int* s_prm = smem;                 // 96: DC bounds, then AC bounds
  int* s_sym = s_prm + 96;           // 512: DC symbols, then AC symbols
  int* s_acw = s_sym + 512;          // window AC unit words
  short* s_j = reinterpret_cast<short*>(s_acw + window);  // LEVELS x window
  short* s_s = s_j + LEVELS * window;                     // LEVELS x window
  for (int k = threadIdx.x; k < 96 + 512; k += THREADS)
    smem[k] = k < 96 ? params[k] : syms[k - 96];
  __syncthreads();

  const long long nbits = nbytes * 8;
  const long long t0 = static_cast<long long>(blockIdx.x) * tile_bits;
  for (int i = threadIdx.x; i < window; i += THREADS) {
    const long long p = t0 + i;
    const unsigned w16 = window16(pay, nbytes, p);
    const int a = unit_word(w16, p, nbits, s_prm + 48, s_sym + 256);
    s_acw[i] = a;
    if (i < tile_bits && p <= nbits) {
      dcw[p] = unit_word(w16, p, nbits, s_prm, s_sym);
      acw[p] = a;
    }
    const int ctrl = (a >> 6) - 2;
    const bool term = ctrl <= 0;  // EOB or error: absorbing
    s_s[i] = static_cast<short>(term ? 0 : (ctrl >> 4) + 1);
    s_j[i] = static_cast<short>(term ? i : min(i + (a & 0x3F), window - 1));
  }
  __syncthreads();
  for (int k = 1; k < LEVELS; ++k) {
    const short* pj = s_j + (k - 1) * window;
    const short* ps = s_s + (k - 1) * window;
    for (int i = threadIdx.x; i < window; i += THREADS) {
      const int j = pj[i];
      s_j[k * window + i] = pj[j];
      s_s[k * window + i] = static_cast<short>(ps[i] + ps[j]);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < tile_bits; i += THREADS) {
    const long long p = t0 + i;
    if (p > nbits) break;
    const int jf = s_j[(LEVELS - 1) * window + i];
    const int sf = s_s[(LEVELS - 1) * window + i];
    long long out;
    if (sf < 63) {  // parked on a terminal unit
      const int a = s_acw[jf];
      const int tc = (a >> 6) - 2;
      out = tc == 0    ? (t0 + jf + (a & 0x3F)) << 2
            : tc == -1 ? ((t0 + jf) << 2) | 1
                       : ((t0 + jf) << 2) | 2;
    } else {  // descend to the unit that crosses position 63
      int cur = i, s = 0;
      for (int k = LEVELS - 2; k >= 0; --k) {
        const int ns = s + s_s[k * window + cur];
        if (ns < 63) {
          s = ns;
          cur = s_j[k * window + cur];
        }
      }
      const int a = s_acw[cur];
      const int cc = (a >> 6) - 2;
      const int crun = cc > 0 ? cc >> 4 : 0;
      out = (cc != ZRL && s + crun + 1 >= 64)
                ? 3
                : (t0 + cur + (a & 0x3F)) << 2;
    }
    outc[p] = static_cast<int>(out);
  }
}

}  // namespace

// pay: (nbytes,) uint8; params: (96,) int32 canonical bounds of the DC
// then the AC table; syms: (512,) int32 their symbol lists; words:
// (3, 8 * nbytes + 1) int32, DC unit, AC unit and AC outcome words.
REPRO_EXPORT int unpack_bits_launch(const unsigned char* pay,
                                    long long nbytes, const int* params,
                                    const int* syms, int* words,
                                    int tile_bits, void* stream) {
  const long long n_pos = nbytes * 8 + 1;
  const int window = tile_bits + MARGIN_BITS;
  const size_t smem = (96 + 512 + window) * sizeof(int) +
                      2 * LEVELS * window * sizeof(short);
  cudaError_t err = cudaFuncSetAttribute(
      unpack_bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_pos + tile_bits - 1) / tile_bits;
  unpack_bits_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      pay, nbytes, params, syms, words, words + n_pos, words + 2 * n_pos,
      tile_bits);
  return static_cast<int>(cudaGetLastError());
}
