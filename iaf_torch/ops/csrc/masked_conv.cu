// K2: one masked stride-1 SAME conv, for Hopper (forward).
//
// Replaces iaf_tpu/ops/masked_conv.py:_conv_kernel (:40, pallas_call at
// :66, entry masked_conv2d :87): the per-conv kernel that the AR net of an
// IAF step runs conv by conv wherever K1's fused chain does not apply (a
// kernel size other than 3). The TPU kernel built one [H*W, kh*kw*cin]
// im2col matrix per image in VMEM and made one MXU matmul of it, dead taps
// included. Here it is an implicit GEMM (masked_conv.cuh) over the live
// taps only: M = N*H*W output pixels, N = cout, K = live taps x cin; the
// weights arrive folded and masked, and the wrapper packs only the live
// taps (13 of 25 for a 5x5 raster mask), so the dead ones cost nothing.
// The output is unrounded f32, as the Pallas kernel's.
//
// Bound on the H100 at the eval shape (1024 images of 16x16, 5x5 raster
// mask, bf16 operands, f32 out): 32->160 moves 184.5 MB for 34.9 GFLOP
// (bytes, 55 us at 3.35 TB/s); 160->160 is 174.5 GFLOP against 251.7 MB
// and 160->64 69.8 GFLOP against 151.0 MB (operations, 176 us and 71 us at
// 989 TFLOP/s). What the design does about it: each input byte is read
// from device memory once per block (staged rows, halo included: 10 rows
// staged for 8 output rows) and the output written once; the operations go
// to the tensor cores, and every weight fragment a warp loads feeds the
// block's 8 M tiles, so the weights (665 KB bf16 for 160->160) cross L2
// once per 128 output pixels. This first version issues mma.sync from one
// warp per pair of output tiles with no pipelining of the weight loads;
// wgmma with TMA-staged weights is the next step toward the bound.
//
// Entry points (plain C, loaded with ctypes): masked_conv_smem_bytes,
// masked_conv_fwd.

#include "masked_conv.cuh"

extern "C" {

// Bytes of dynamic shared memory one block of ``tr`` output rows asks for
// (the wrapper picks tr so that this fits the 227 KB a Hopper block may
// use); span = dy_hi - dy_lo of the taps.
size_t masked_conv_smem_bytes(int tr, int W, int cin, int kw, int span,
                              int mma) {
  return conv_smem_bytes(tr, W, cin, kw, span, mma);
}

// out [N,H,W,cout] f32 = the conv of x [N,H,W,cin] (T) with the weights
// over the ntaps (dy, dx) pairs of ``taps`` (host array), packed in mma.sync
// fragment order (mma = 1: bf16, W % 16 == 0, W <= 16 * MT, cin % 16 == 0,
// cout % 8 == 0) or [taps][cin][cout] (mma = 0). T = bf16 if bf16 else f32.
// Returns cudaGetLastError() after the launch (0 on success).
int masked_conv_fwd(const void* x, const void* w, void* out, const int* taps,
                    int ntaps, int n_images, int H, int W, int cin, int cout,
                    int kh, int kw, int tr, int bf16, int mma, int threads,
                    void* stream) {
  ConvArgs a;
  int e = conv_prepare(a, x, w, out, taps, ntaps, H, W, cin, cout, kh, kw,
                       tr);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma) {
    if (!bf16 || W % 16 || W > 16 * MT || cin % 16 || cout % 8 ||
        tr * (W / 16) > MT)
      return (int)cudaErrorInvalidValue;
    return conv_launch(conv_mma_kernel<__nv_bfloat16, float>, a, n_images,
                       kw, 1, threads, s);
  }
  return bf16 ? conv_launch(conv_fma_kernel<__nv_bfloat16, __nv_bfloat16,
                                            float>,
                            a, n_images, kw, 0, threads, s)
              : conv_launch(conv_fma_kernel<float, float, float>, a,
                            n_images, kw, 0, threads, s);
}

}  // extern "C"
