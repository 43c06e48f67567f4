// Blockwise 8x8 2-D DCT and inverse DCT, block-planar, fp32.
//
// Replaces the TPU kernel repro/kernels/dct8x8/kernel.py:dct8x8_pallas
// (_dct_kernel, _idct_kernel): (nblocks, 64) @ T per VMEM tile on the MXU.
//
// What bounds it on the H100: bytes.  It reads 4 bytes and writes 4 bytes
// per pixel (2.4 ps at 3.35 TB/s); the function needs at least 32 fp32
// operations per pixel (separable 8-point products, 0.5 ps at 67 TFLOP/s),
// and even the 64 fused multiply-adds per pixel this kernel does (1.9 ps)
// stay below the memory time.  The design
// reads and writes every pixel once (strips staged in shared memory, T
// staged once per CTA and reused over 4 strips), keeps the products on the
// CUDA cores in fp32, and feeds them from shared memory with one float4
// broadcast per four FMAs (kron8x8.cuh).

#include "kron8x8.cuh"

namespace {

template <int MODE>
int launch(const float* x, const float* t, float* out, int n, int h, int w,
           void* stream) {
  kron8x8::kron_kernel<MODE>
      <<<kron8x8::grid_for(n, h, w), kron8x8::THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(x, t, nullptr, out, nullptr, h,
                                              w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (n, h, w) float32, h and w multiples of 8; t: (64, 64) kron(C8, C8).
REPRO_EXPORT int dct8x8_forward(const float* x, const float* t, float* out,
                                int n, int h, int w, void* stream) {
  return launch<kron8x8::FORWARD>(x, t, out, n, h, w, stream);
}

REPRO_EXPORT int dct8x8_inverse(const float* x, const float* t, float* out,
                                int n, int h, int w, void* stream) {
  return launch<kron8x8::INVERSE>(x, t, out, n, h, w, stream);
}
