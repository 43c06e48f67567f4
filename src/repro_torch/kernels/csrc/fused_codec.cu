// One-pass codec roundtrip: level shift -> 2-D DCT -> quantise ->
// dequantise -> inverse DCT -> round and clip, writing the reconstruction
// (float32) and the quantised levels (int32, block-planar).
//
// Replaces the TPU kernel repro/kernels/fused_codec/kernel.py:
// fused_codec_pallas (_make_kernel), in both of its transforms.
//
// exact: two 64-term fp32 products per pixel against kron(C8, C8) on the
//   CUDA cores (kron8x8.cuh, CODEC mode).  Bound by bytes: 12 bytes per
//   pixel (4 read, 4 + 4 written), 3.6 ps at 3.35 TB/s, against the
//   function's least 72 fp32 operations (two separable transforms of 32
//   and 8 around them), 1.1 ps at 67 TFLOP/s.  The 64-term products this
//   kernel does take 263 operations, 3.9 ps, so as written it can be
//   held back by its arithmetic before its bytes.
//   The design reads and writes each pixel once, keeps the coefficients
//   of a strip in shared memory between the two products, and feeds the
//   FMAs with float4 broadcasts from shared memory.
// cordic: the Loeffler graph with CORDIC rotations forward and inverse,
//   one 8x8 block per thread in registers (cordic_graph.cuh).  By the
//   data sheet bound by bytes (12 bytes against 133.5 operations per
//   pixel), in practice by ALU issue, as in cordic_loeffler.cu; the
//   design keeps the whole roundtrip in registers so no intermediate
//   touches memory.
//
// Quantisation divides (IEEE, not a reciprocal product) and rounds half to
// even with rintf, as jnp.round(coef / q) does.

#include "cordic_graph.cuh"
#include "kron8x8.cuh"

namespace {

constexpr int CORDIC_THREADS = 128;

template <bool FIXED>
__global__ void __launch_bounds__(CORDIC_THREADS)
fused_cordic_kernel(const float* __restrict__ x,
                    const float* __restrict__ qvec, float* __restrict__ rec,
                    int32_t* __restrict__ levels, int n, int h, int w,
                    const CordicParams params) {
  __shared__ CordicParams p;
  __shared__ float qs[64];
  cordic_graph::load_params(&p, params);
  if (threadIdx.x < 64) qs[threadIdx.x] = qvec[threadIdx.x];
  __syncthreads();
  const cordic_graph::BlockPos pos = cordic_graph::block_pos(n, h, w);
  if (!pos.valid) return;
  float v[64];
  cordic_graph::load_block(x + pos.offset, w, v);
#pragma unroll
  for (int i = 0; i < 64; ++i) v[i] -= 128.f;  // JPEG level shift
  cordic_graph::fwd2d<FIXED>(v, p);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int32_t lv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float qv = qs[8 * r + c];
      const float l = rintf(v[8 * r + c] / qv);
      lv[c] = static_cast<int32_t>(l);
      v[8 * r + c] = l * qv;
    }
    int32_t* dst = levels + pos.offset + r * w;
    *reinterpret_cast<int4*>(dst) = make_int4(lv[0], lv[1], lv[2], lv[3]);
    *reinterpret_cast<int4*>(dst + 4) = make_int4(lv[4], lv[5], lv[6], lv[7]);
  }
  cordic_graph::inv2d<FIXED>(v, p);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    v[i] = fminf(fmaxf(rintf(v[i] + 128.f), 0.f), 255.f);
#pragma unroll
  for (int r = 0; r < 8; ++r)
    cordic_graph::store_row(rec + pos.offset + r * w, v + 8 * r);
}

}  // namespace

// x, rec: (n, h, w) float32; levels: (n, h, w) int32; h, w multiples of 8;
// t: (64, 64) kron(C8, C8); qvec: (64,) quantisation steps, row-major.
REPRO_EXPORT int fused_codec_exact(const float* x, const float* t,
                                   const float* qvec, float* rec,
                                   int32_t* levels, int n, int h, int w,
                                   void* stream) {
  kron8x8::kron_kernel<kron8x8::CODEC>
      <<<kron8x8::grid_for(n, h, w), kron8x8::THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(x, t, qvec, rec, levels, h, w);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int fused_codec_cordic(const float* x, const float* qvec,
                                    float* rec, int32_t* levels, int n, int h,
                                    int w, const CordicParams* params,
                                    void* stream) {
  const int64_t blocks = static_cast<int64_t>(n) * (h / 8) * (w / 8);
  const dim3 grid(
      static_cast<unsigned>((blocks + CORDIC_THREADS - 1) / CORDIC_THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (params->step != 0.f)
    fused_cordic_kernel<true><<<grid, CORDIC_THREADS, 0, s>>>(
        x, qvec, rec, levels, n, h, w, *params);
  else
    fused_cordic_kernel<false><<<grid, CORDIC_THREADS, 0, s>>>(
        x, qvec, rec, levels, n, h, w, *params);
  return static_cast<int>(cudaGetLastError());
}
