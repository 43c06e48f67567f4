// Blockwise 8x8 transforms as 64-term products against the Kronecker
// operator T = kron(C8, C8) (row-major vec of each block), shared by
// dct8x8.cu and the exact mode of fused_codec.cu.
//
// Layout: block-planar, as the TPU kernels: the 64 coefficients of the
// 8x8 pixel block (i, j) live at pixels [8i, 8i+8) x [8j, 8j+8), row-major.
//
// Work split.  A CTA of 256 threads walks a 256-column strip of an image,
// 8 rows (32 pixel blocks) at a time, for up to STRIPS_PER_CTA strips down
// the image.  Thread (c, g) = (tid % 64, tid / 64) computes coefficient c
// of the blocks g, g+4, ..., g+28 of the strip: 8 dot products of 64 terms
// in fp32 on the CUDA cores (fmaf, k in order 0..63; no TF32).
//
// Shared memory: the operator with a row stride of 65 floats, so that
// both T[c][k] (forward) and T[k][c] (inverse) read by 32 lanes of
// consecutive c fall in 32 distinct banks; the strip (8 x 256 floats),
// read as float4 broadcasts (every lane of a warp works on the same
// block); and, for the codec, the dequantised coefficients of the strip.
// T is staged once per CTA and reused over its strips.
#pragma once

#include "common.cuh"

namespace kron8x8 {

constexpr int THREADS = 256;
constexpr int STRIP_COLS = 256;            // 32 blocks of 8 columns
constexpr int STRIP_BLOCKS = STRIP_COLS / 8;
constexpr int STRIPS_PER_CTA = 4;          // 32 rows per CTA
constexpr int TPAD = 65;
constexpr int PER_THREAD = STRIP_BLOCKS / (THREADS / 64);  // 8 blocks

enum Mode { FORWARD = 0, INVERSE = 1, CODEC = 2 };

// acc[i] = sum_k T(c, k) * src[block g + 4 i][k], with T(c, k) = T[c][k]
// when TRANSPOSED is false (forward) and T[k][c] when true (inverse).
// src holds each block's 64 values at src[block * BSTRIDE_BLOCK +
// (k / 8) * ROW_STRIDE + k % 8].
template <bool TRANSPOSED, int ROW_STRIDE, int BSTRIDE_BLOCK>
__device__ __forceinline__ void products(const float* ts, const float* src,
                                         int c, int g, float* acc) {
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int k = 0; k < 64; k += 4) {
    float t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      t[u] = TRANSPOSED ? ts[(k + u) * TPAD + c] : ts[c * TPAD + k + u];
    const int off = (k >> 3) * ROW_STRIDE + (k & 7);
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(
          src + (g + 4 * i) * BSTRIDE_BLOCK + off);
      acc[i] = fmaf(t[0], xv.x, acc[i]);
      acc[i] = fmaf(t[1], xv.y, acc[i]);
      acc[i] = fmaf(t[2], xv.z, acc[i]);
      acc[i] = fmaf(t[3], xv.w, acc[i]);
    }
  }
}

// FORWARD: out = T . x per block.  INVERSE: out = T^T . x per block.
// CODEC (fused_codec, exact): x - 128 -> T . x -> levels = rint(coef / q)
// -> deq = levels * q -> T^T . deq -> out = clamp(rint(rec + 128), 0, 255).
template <int MODE>
__global__ void __launch_bounds__(THREADS)
kron_kernel(const float* __restrict__ x, const float* __restrict__ t,
            const float* __restrict__ qvec, float* __restrict__ out,
            int32_t* __restrict__ levels, int h, int w) {
  __shared__ float ts[64 * TPAD];
  __shared__ __align__(16) float xs[8 * STRIP_COLS];
  __shared__ __align__(16) float ds[MODE == CODEC ? STRIP_BLOCKS * 64 : 4];

  const int tid = threadIdx.x;
  const int c = tid & 63;
  const int g = tid >> 6;
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const int col0 = blockIdx.x * STRIP_COLS;
  const int nblk = min(STRIP_COLS, w - col0) / 8;
  // where coefficient c of a block sits inside the block, in pixels
  const int cr = c >> 3, cc = c & 7;

  for (int i = tid; i < 64 * 64; i += THREADS)
    ts[(i >> 6) * TPAD + (i & 63)] = t[i];
  const float qv = MODE == CODEC ? qvec[c] : 1.f;

  for (int s = 0; s < STRIPS_PER_CTA; ++s) {
    const int row0 = (blockIdx.y * STRIPS_PER_CTA + s) * 8;
    if (row0 >= h) break;  // uniform over the CTA
    __syncthreads();       // T staged; the previous strip is done with xs/ds
    for (int i = tid; i < 8 * STRIP_COLS / 4; i += THREADS) {
      const int r = i / (STRIP_COLS / 4);
      const int c4 = (i % (STRIP_COLS / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col0 + c4 < w)
        v = *reinterpret_cast<const float4*>(
            x + plane + static_cast<size_t>(row0 + r) * w + col0 + c4);
      if (MODE == CODEC) {  // JPEG level shift
        v.x -= 128.f; v.y -= 128.f; v.z -= 128.f; v.w -= 128.f;
      }
      *reinterpret_cast<float4*>(xs + r * STRIP_COLS + c4) = v;
    }
    __syncthreads();

    float acc[PER_THREAD];
    products<MODE == INVERSE, STRIP_COLS, 8>(ts, xs, c, g, acc);

    const size_t pix = plane + static_cast<size_t>(row0 + cr) * w + col0 + cc;
    if (MODE != CODEC) {
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const int j = g + 4 * i;
        if (j < nblk) out[pix + j * 8] = acc[i];
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int j = g + 4 * i;
      const float lv = rintf(acc[i] / qv);   // IEEE division, half to even
      if (j < nblk) levels[pix + j * 8] = static_cast<int32_t>(lv);
      ds[j * 64 + c] = lv * qv;
    }
    __syncthreads();
    products<true, 8, 64>(ts, ds, c, g, acc);
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int j = g + 4 * i;
      if (j < nblk)
        out[pix + j * 8] = fminf(fmaxf(rintf(acc[i] + 128.f), 0.f), 255.f);
    }
  }
}

inline dim3 grid_for(int n, int h, int w) {
  return dim3((w + STRIP_COLS - 1) / STRIP_COLS,
              (h / 8 + STRIPS_PER_CTA - 1) / STRIPS_PER_CTA, n);
}

}  // namespace kron8x8
