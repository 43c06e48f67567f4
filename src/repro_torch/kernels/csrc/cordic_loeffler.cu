// Blockwise Cordic-Loeffler 2-D DCT and inverse DCT, block-planar, fp32:
// the paper's own kernel.
//
// Replaces the TPU kernel
// repro/kernels/cordic_loeffler/kernel.py:cordic_loeffler_pallas
// (_make_kernel): the 4-stage Loeffler graph with CORDIC micro-rotations
// and stage-output fixed-point rounding, vectorised over a VMEM tile.
//
// What bounds it on the H100.  By the data sheet, bytes: 8 bytes per pixel
// against about 63 fp32 operations per pixel and direction (2.4 ps against
// 0.9 ps per pixel at 3.35 TB/s and 67 TFLOP/s).  In practice ALU issue:
// with the fixed-point grid two thirds of those operations round to the
// grid (a product, rintf, a product), and rintf is a conversion that
// issues at a fraction of the fp32 rate.  The design
// gives each thread one whole 8x8 block in registers, so the 16
// one-dimensional passes need no shared memory and no synchronisation,
// and each pixel is read and written once with float4 accesses.

#include "cordic_graph.cuh"

namespace {

constexpr int THREADS = 128;

template <bool FIXED, bool INVERSE>
__global__ void __launch_bounds__(THREADS)
cordic_loeffler_kernel(const float* __restrict__ x, float* __restrict__ out,
                       int n, int h, int w, const CordicParams params) {
  __shared__ CordicParams p;
  cordic_graph::load_params(&p, params);
  __syncthreads();
  const cordic_graph::BlockPos pos = cordic_graph::block_pos(n, h, w);
  if (!pos.valid) return;
  float v[64];
  cordic_graph::load_block(x + pos.offset, w, v);
  if (INVERSE)
    cordic_graph::inv2d<FIXED>(v, p);
  else
    cordic_graph::fwd2d<FIXED>(v, p);
#pragma unroll
  for (int r = 0; r < 8; ++r)
    cordic_graph::store_row(out + pos.offset + r * w, v + 8 * r);
}

template <bool INVERSE>
int launch(const float* x, float* out, int n, int h, int w,
           const CordicParams* params, void* stream) {
  const int64_t blocks = static_cast<int64_t>(n) * (h / 8) * (w / 8);
  const dim3 grid(static_cast<unsigned>((blocks + THREADS - 1) / THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (params->step != 0.f)
    cordic_loeffler_kernel<true, INVERSE>
        <<<grid, THREADS, 0, s>>>(x, out, n, h, w, *params);
  else
    cordic_loeffler_kernel<false, INVERSE>
        <<<grid, THREADS, 0, s>>>(x, out, n, h, w, *params);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (n, h, w) float32, h and w multiples of 8; params: host pointer,
// copied into the launch.
REPRO_EXPORT int cordic_loeffler_forward(const float* x, float* out, int n,
                                         int h, int w,
                                         const CordicParams* params,
                                         void* stream) {
  return launch<false>(x, out, n, h, w, params, stream);
}

REPRO_EXPORT int cordic_loeffler_inverse(const float* x, float* out, int n,
                                         int h, int w,
                                         const CordicParams* params,
                                         void* stream) {
  return launch<true>(x, out, n, h, w, params, stream);
}
