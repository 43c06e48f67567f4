// The Loeffler 8-point DCT flow graph with CORDIC rotations and
// fixed-point rounding, shared by cordic_loeffler.cu and the cordic mode
// of fused_codec.cu.
//
// Bit-exactness with the reference (repro/core/loeffler.py, cordic.py):
// every operation below is one float32 operation in the reference's
// order, rounded to nearest; the library is compiled with --fmad=false so
// no product is fused into a following sum; rintf rounds half to even as
// jnp.round does; constants are the reference's float64 values rounded
// to float32 once.
//
// The CORDIC schedule is resolved on the host and arrives as a kernel
// argument (CordicParams); each CTA copies it into shared memory, where
// every lane reads the same word (a broadcast).
#pragma once

#include "common.cuh"

#define REPRO_MAX_CORDIC_ITERS 32

// One static rotation angle.
struct CordicRot {
  float s[REPRO_MAX_CORDIC_ITERS];  // -sigma_k * 2^-k, micro-rotation k
  float gain;                       // shift-add approximation of 1/K
};

// rot[0..2]: THETA_ODD_A (3pi/16), THETA_ODD_B (pi/16), THETA_EVEN (pi/8);
// rot[3..5]: the same angles negated, for the inverse graph.
struct CordicParams {
  CordicRot rot[6];
  int iterations;
  float step;      // fixed-point grid step 2^(12 - bits); 0 = float datapath
  float inv_step;  // 1 / step
};

namespace cordic_graph {

// float32(1 / (2 sqrt 2)), the reference's float64 constant rounded once.
constexpr float INV_2SQRT2 = static_cast<float>(0.35355339059327373);

__device__ __forceinline__ void load_params(CordicParams* dst,
                                            const CordicParams& src) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&src);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(CordicParams) / 4);
       i += blockDim.x)
    d[i] = s[i];
}

template <bool FIXED>
__device__ __forceinline__ float q(float t, const CordicParams& p) {
  return FIXED ? rintf(t * p.inv_step) * p.step : t;
}

// (u, v) -> (u cos + v sin, -u sin + v cos), by micro-rotations.
template <bool FIXED>
__device__ __forceinline__ void rotate(float& u, float& v, const CordicRot& r,
                                       const CordicParams& p) {
  for (int k = 0; k < p.iterations; ++k) {
    const float s = r.s[k];
    const float nu = q<FIXED>(u - s * v, p);
    const float nv = q<FIXED>(v + s * u, p);
    u = nu;
    v = nv;
  }
  u = q<FIXED>(u * r.gain, p);
  v = q<FIXED>(v * r.gain, p);
}

// Forward 8-point graph on v[0], v[S], ..., v[7S], in place.
template <bool FIXED, int S>
__device__ __forceinline__ void fwd8(float* v, const CordicParams& p) {
  const float x0 = v[0], x1 = v[S], x2 = v[2 * S], x3 = v[3 * S];
  const float x4 = v[4 * S], x5 = v[5 * S], x6 = v[6 * S], x7 = v[7 * S];
  // stage 1: butterflies
  const float a0 = q<FIXED>(x0 + x7, p), a1 = q<FIXED>(x1 + x6, p);
  const float a2 = q<FIXED>(x2 + x5, p), a3 = q<FIXED>(x3 + x4, p);
  float d3 = q<FIXED>(x3 - x4, p), d2 = q<FIXED>(x2 - x5, p);
  float d1 = q<FIXED>(x1 - x6, p), d0 = q<FIXED>(x0 - x7, p);
  // stage 2: even butterflies, odd rotations
  const float b0 = q<FIXED>(a0 + a3, p), b1 = q<FIXED>(a1 + a2, p);
  float b2 = q<FIXED>(a1 - a2, p), b3 = q<FIXED>(a0 - a3, p);
  rotate<FIXED>(d3, d0, p.rot[0], p);  // (r4, r7)
  rotate<FIXED>(d2, d1, p.rot[1], p);  // (r5, r6)
  const float r4 = d3, r7 = d0, r5 = d2, r6 = d1;
  // stage 3: even output butterfly and rotation, odd butterflies
  const float y0 = q<FIXED>(b0 + b1, p), y4 = q<FIXED>(b0 - b1, p);
  const float c4 = q<FIXED>(r4 + r6, p), c5 = q<FIXED>(r7 - r5, p);
  const float c6 = q<FIXED>(r4 - r6, p), c7 = q<FIXED>(r7 + r5, p);
  rotate<FIXED>(b3, b2, p.rot[2], p);  // (z2, z6)
  const float z2 = b3, z6 = b2;
  // stage 4: output scalings
  v[0] = q<FIXED>(y0 * INV_2SQRT2, p);
  v[4 * S] = q<FIXED>(y4 * INV_2SQRT2, p);
  v[2 * S] = q<FIXED>(z2 * 0.5f, p);
  v[6 * S] = q<FIXED>(-z6 * 0.5f, p);
  v[1 * S] = q<FIXED>((c4 + c7) * INV_2SQRT2, p);
  v[7 * S] = q<FIXED>((c7 - c4) * INV_2SQRT2, p);
  v[3 * S] = q<FIXED>(c5 * 0.5f, p);
  v[5 * S] = q<FIXED>(c6 * 0.5f, p);
}

// Inverse (transposed) 8-point graph, rotations by the negated angles.
template <bool FIXED, int S>
__device__ __forceinline__ void inv8(float* v, const CordicParams& p) {
  const float Y0 = v[0], Y1 = v[S], Y2 = v[2 * S], Y3 = v[3 * S];
  const float Y4 = v[4 * S], Y5 = v[5 * S], Y6 = v[6 * S], Y7 = v[7 * S];
  // transpose of stage 4
  const float y0 = q<FIXED>(Y0 * INV_2SQRT2, p);
  const float y4 = q<FIXED>(Y4 * INV_2SQRT2, p);
  const float c4 = q<FIXED>((Y1 - Y7) * INV_2SQRT2, p);
  const float c7 = q<FIXED>((Y1 + Y7) * INV_2SQRT2, p);
  const float c5 = q<FIXED>(Y3 * 0.5f, p);
  const float c6 = q<FIXED>(Y5 * 0.5f, p);
  const float z2 = q<FIXED>(Y2 * 0.5f, p);
  const float z6 = q<FIXED>(-Y6 * 0.5f, p);
  // transpose of stage 3
  const float b0 = q<FIXED>(y0 + y4, p), b1 = q<FIXED>(y0 - y4, p);
  float b3 = z2, b2 = z6;
  rotate<FIXED>(b3, b2, p.rot[5], p);  // -THETA_EVEN
  const float r4 = q<FIXED>(c4 + c6, p), r6 = q<FIXED>(c4 - c6, p);
  const float r7 = q<FIXED>(c7 + c5, p), r5 = q<FIXED>(c7 - c5, p);
  // transpose of stage 2
  const float a0 = q<FIXED>(b0 + b3, p), a3 = q<FIXED>(b0 - b3, p);
  const float a1 = q<FIXED>(b1 + b2, p), a2 = q<FIXED>(b1 - b2, p);
  float d3 = r4, d0 = r7, d2 = r5, d1 = r6;
  rotate<FIXED>(d3, d0, p.rot[3], p);  // -THETA_ODD_A
  rotate<FIXED>(d2, d1, p.rot[4], p);  // -THETA_ODD_B
  // transpose of stage 1
  v[0] = q<FIXED>(a0 + d0, p);
  v[7 * S] = q<FIXED>(a0 - d0, p);
  v[1 * S] = q<FIXED>(a1 + d1, p);
  v[6 * S] = q<FIXED>(a1 - d1, p);
  v[2 * S] = q<FIXED>(a2 + d2, p);
  v[5 * S] = q<FIXED>(a2 - d2, p);
  v[3 * S] = q<FIXED>(a3 + d3, p);
  v[4 * S] = q<FIXED>(a3 - d3, p);
}

// 2-D forward on one 8x8 block held row-major in v[64]: rows, then columns.
template <bool FIXED>
__device__ __forceinline__ void fwd2d(float* v, const CordicParams& p) {
#pragma unroll
  for (int r = 0; r < 8; ++r) fwd8<FIXED, 1>(v + 8 * r, p);
#pragma unroll
  for (int c = 0; c < 8; ++c) fwd8<FIXED, 8>(v + c, p);
}

// 2-D inverse: columns, then rows.
template <bool FIXED>
__device__ __forceinline__ void inv2d(float* v, const CordicParams& p) {
#pragma unroll
  for (int c = 0; c < 8; ++c) inv8<FIXED, 8>(v + c, p);
#pragma unroll
  for (int r = 0; r < 8; ++r) inv8<FIXED, 1>(v + 8 * r, p);
}

// One thread per 8x8 block: where the thread's block starts, and whether
// the thread has one (the last CTA may run past the end).
// Consecutive threads take horizontally adjacent blocks, so a warp's
// row loads cover one contiguous 1 KB span.
struct BlockPos {
  size_t offset;  // of the block's top-left pixel
  bool valid;
};

__device__ __forceinline__ BlockPos block_pos(int n, int h, int w) {
  const int64_t hb = h / 8, wb = w / 8;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n * hb * wb) return {0, false};
  const int64_t img = b / (hb * wb), rem = b % (hb * wb);
  const int64_t bi = rem / wb, bj = rem % wb;
  return {static_cast<size_t>((img * h + bi * 8) * w + bj * 8), true};
}

__device__ __forceinline__ void load_block(const float* src, int w, float* v) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(src + r * w);
    const float4 b = *reinterpret_cast<const float4*>(src + r * w + 4);
    v[8 * r + 0] = a.x; v[8 * r + 1] = a.y; v[8 * r + 2] = a.z;
    v[8 * r + 3] = a.w; v[8 * r + 4] = b.x; v[8 * r + 5] = b.y;
    v[8 * r + 6] = b.z; v[8 * r + 7] = b.w;
  }
}

__device__ __forceinline__ void store_row(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

}  // namespace cordic_graph
