// DCT-domain gradient compression: rows of 64 f32 samples to their lowest
// `keep` DCT-II coefficients as int8 codes with one f32 scale per row
// (encode), and back (decode).
//
// Replaces the TPU kernels src/repro/kernels/grad_dct/kernel.py:61
// grad_dct_encode_pallas and :81 grad_dct_decode_pallas, which multiply a
// VMEM tile of rows by C64^T (C64) on the MXU over a grid of row tiles.
//
// What bounds it on the H100: bytes.  At keep=16 a row moves 276 B: 256 B
// of f32 samples and 16 + 4 B of wire, read or written once; its product
// is 16 x 64 multiply-adds, 8 operations per byte, far below the card's
// fp32 rate per byte of memory.  The design reads and writes each row
// once: one warp owns a row at a time, its lanes load the 64 samples
// (coalesced, two per lane) and C64's first `keep` rows sit in shared
// memory, staged once per block.  Products are fp32 fmaf on the CUDA
// cores in a fixed order (j = 0..63 for encode, k = 0..keep-1 for decode),
// so a row's result does not depend on the tile, the grid or its
// neighbours.  Vectorised 16-byte loads and TMA are later work.
//
// Arithmetic as the reference: scale = max(max|kept| / 127, 1e-30) with
// an IEEE division, q = clip(rint(kept / scale), -127, 127) with a true
// division and rounding half to even; decode multiplies q * scale in f32
// before the product.  Offsets are int64; each block masks its ragged
// last tile itself.

#include "common.cuh"

namespace {

constexpr int BLOCK = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

// g: (rows, 64) f32; c: (64, 64) DCT-II, row-major; q: (rows, keep) int8;
// s: (rows,) f32.  Block b covers rows [b * block_rows, +block_rows).
__global__ void __launch_bounds__(THREADS)
encode_kernel(const float* __restrict__ g, const float* __restrict__ c,
              signed char* __restrict__ q, float* __restrict__ s,
              long long rows, int keep, int block_rows) {
  // ct[j * keep + k] = C[k][j]: lanes read consecutive words per j
  extern __shared__ float ct[];
  for (int i = threadIdx.x; i < BLOCK * keep; i += THREADS) {
    const int j = i / keep, k = i % keep;
    ct[i] = c[k * BLOCK + j];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * block_rows;
  const long long last = min(first + block_rows, rows);
  const bool has0 = lane < keep, has1 = lane + 32 < keep;
  for (long long r = first + warp; r < last; r += WARPS) {
    const float* row = g + r * BLOCK;
    const float lo = row[lane], hi = row[lane + 32];
    float k0 = 0.0f, k1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BLOCK; ++j) {
      const float gj = __shfl_sync(FULL, j < 32 ? lo : hi, j & 31);
      if (has0) k0 = fmaf(gj, ct[j * keep + lane], k0);
      if (has1) k1 = fmaf(gj, ct[j * keep + lane + 32], k1);
    }
    float m = fmaxf(has0 ? fabsf(k0) : 0.0f, has1 ? fabsf(k1) : 0.0f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    const float scale = fmaxf(m / 127.0f, 1e-30f);
    signed char* out = q + r * keep;
    if (has0) out[lane] = static_cast<signed char>(
        fminf(fmaxf(rintf(k0 / scale), -127.0f), 127.0f));
    if (has1) out[lane + 32] = static_cast<signed char>(
        fminf(fmaxf(rintf(k1 / scale), -127.0f), 127.0f));
    if (lane == 0) s[r] = scale;
  }
}

// q: (rows, keep) int8; s: (rows,) f32; c: (64, 64); out: (rows, 64) f32.
__global__ void __launch_bounds__(THREADS)
decode_kernel(const signed char* __restrict__ q, const float* __restrict__ s,
              const float* __restrict__ c, float* __restrict__ out,
              long long rows, int keep, int block_rows) {
  // cs[k * 64 + j] = C[k][j], the first `keep` rows of C
  extern __shared__ float cs[];
  for (int i = threadIdx.x; i < BLOCK * keep; i += THREADS) cs[i] = c[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * block_rows;
  const long long last = min(first + block_rows, rows);
  for (long long r = first + warp; r < last; r += WARPS) {
    const signed char* codes = q + r * keep;
    const float scale = s[r];
    const float v0 = lane < keep ? static_cast<float>(codes[lane]) * scale
                                 : 0.0f;
    const float v1 = lane + 32 < keep
                         ? static_cast<float>(codes[lane + 32]) * scale
                         : 0.0f;
    float o0 = 0.0f, o1 = 0.0f;
    for (int k = 0; k < keep; ++k) {
      const float vk = __shfl_sync(FULL, k < 32 ? v0 : v1, k & 31);
      o0 = fmaf(vk, cs[k * BLOCK + lane], o0);
      o1 = fmaf(vk, cs[k * BLOCK + lane + 32], o1);
    }
    float* row = out + r * BLOCK;
    row[lane] = o0;
    row[lane + 32] = o1;
  }
}

unsigned grid_for(long long rows, int block_rows) {
  return static_cast<unsigned>((rows + block_rows - 1) / block_rows);
}

size_t smem_for(int keep) { return sizeof(float) * BLOCK * keep; }

}  // namespace

// g: (rows, 64) f32; c: (64, 64) C64; q: (rows, keep) int8; s: (rows,) f32.
// 1 <= keep <= 64, rows >= 1, block_rows >= 1.
REPRO_EXPORT int grad_dct_encode(const float* g, const float* c,
                                 signed char* q, float* s, long long rows,
                                 int keep, int block_rows, void* stream) {
  encode_kernel<<<grid_for(rows, block_rows), THREADS, smem_for(keep),
                  static_cast<cudaStream_t>(stream)>>>(g, c, q, s, rows,
                                                       keep, block_rows);
  return static_cast<int>(cudaGetLastError());
}

// q: (rows, keep) int8; s: (rows,) f32; c: (64, 64) C64; out: (rows, 64).
REPRO_EXPORT int grad_dct_decode(const signed char* q, const float* s,
                                 const float* c, float* out, long long rows,
                                 int keep, int block_rows, void* stream) {
  decode_kernel<<<grid_for(rows, block_rows), THREADS, smem_for(keep),
                  static_cast<cudaStream_t>(stream)>>>(q, s, c, out, rows,
                                                       keep, block_rows);
  return static_cast<int>(cudaGetLastError());
}
