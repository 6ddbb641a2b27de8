// K2: one masked stride-1 SAME conv, for Hopper (forward).
//
// Replaces iaf_tpu/ops/masked_conv.py:_conv_kernel (:40, pallas_call at
// :66, entry masked_conv2d :87): the per-conv kernel that the AR net of an
// IAF step runs conv by conv wherever K1's fused chain does not apply (a
// kernel size other than 3, or a 3x3 chain deeper than K1's shared memory
// holds). The TPU kernel built one [H*W, kh*kw*cin] im2col matrix per
// image in VMEM and made one MXU matmul of it, dead taps included. Here it
// is an implicit GEMM over the live taps only: M = N*H*W output pixels,
// N = cout, K = live taps x cin; the weights arrive folded and masked, and
// the wrapper packs only the live taps (13 of 25 for a 5x5 raster mask),
// so the dead ones cost nothing. The output is unrounded f32, as the
// Pallas kernel's.
//
// Bound on the H100 at the eval shape (1024 images of 16x16, 5x5 raster
// mask, bf16 operands, f32 out): 32->160 moves 184.5 MB for 34.9 GFLOP
// (bytes, 55 us at 3.35 TB/s); 160->160 is 174.5 GFLOP against 251.7 MB
// and 160->64 69.8 GFLOP against 151.0 MB (operations, 176 us and 71 us at
// 989 TFLOP/s).
//
// In f32 (the f32 recipe) the same convs are three TF32 products per f32
// product: 3 x 174.5 GFLOP for 160->160 at 495 TFLOP/s, 1.06 ms; 0.21 ms
// for 32->160 and 0.42 ms for 160->64 (bound by operations; any kernel with
// exact f32 products on the CUDA cores has a third of those FLOP at 67
// TFLOP/s, 2.6, 0.52 and 1.04 ms, as its floor).
//
// Design: conv_wgmma_kernel<N, float> (masked_conv.cuh; bf16 on the
// tensor cores, 128-pixel tiles), conv_tf32_kernel<N> (f32 by 3xTF32 on
// the tensor cores, the same tiles) and conv_fma_kernel for the shapes the
// tensor-core kernels do not tile.
//
// Entry points (plain C, loaded with ctypes): masked_conv_smem_bytes and
// masked_conv_fwd (FMA path), masked_conv_wgmma_stages,
// masked_conv_fwd_wgmma and masked_conv_fwd_tf32 (tensor-core paths).

#include "masked_conv.cuh"

extern "C" {

// Bytes of dynamic shared memory one FMA-path block of ``tr`` output rows
// asks for (the wrapper picks tr so that this fits the 227 KB a Hopper
// block may use); span = dy_hi - dy_lo of the taps.
size_t masked_conv_smem_bytes(int tr, int W, int cin, int kw, int span) {
  return conv_smem_bytes(tr, W, cin, kw, span);
}

// Ring stages the tensor-core kernel (bf16, or with f32 = 1 the 3xTF32
// instantiation) gets within ``limit`` bytes at this shape (npad: cout
// rounded up to an instantiated width); it takes the shape when this is
// at least 2.
int masked_conv_wgmma_stages(int W, int cin, int kw, int span, int npad,
                             int ntaps, size_t limit, int f32) {
  const int tr = wg_tile_rows(W);
  return tr ? wg_plan(tr, W, cin, kw, span, npad, ntaps, limit, f32).stages
            : 0;
}

// out [N,H,W,cout] f32 = the conv of x [N,H,W,cin] (T) with the weights
// [taps][cin][cout] (T) over the ntaps (dy, dx) pairs of ``taps`` (host
// array), on the CUDA cores. T = bf16 if bf16 else f32. Returns
// cudaGetLastError() after the launch (0 on success).
int masked_conv_fwd(const void* x, const void* w, void* out, const int* taps,
                    int ntaps, int n_images, int H, int W, int cin, int cout,
                    int kh, int kw, int tr, int bf16, int threads,
                    void* stream) {
  ConvArgs a;
  int e = conv_prepare(a, x, w, out, taps, ntaps, H, W, cin, cout, kh, kw,
                       tr);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? conv_launch(conv_fma_kernel<__nv_bfloat16, __nv_bfloat16,
                                            float>,
                            a, n_images, kw, threads, s)
              : conv_launch(conv_fma_kernel<float, float, float>, a,
                            n_images, kw, threads, s);
}

// The same conv on the tensor cores (f32 out): x bf16 (16-byte aligned),
// the weights packed as conv_wgmma_kernel reads them with their columns
// zero-padded to npad; see wgmma_conv.
int masked_conv_fwd_wgmma(const void* x, const void* w, void* out,
                          const int* taps, int ntaps, int n_images, int H,
                          int W, int cin, int cout, int npad, int kh, int kw,
                          size_t limit, void* stream) {
  return wgmma_conv<float, false>(x, w, out, taps, ntaps, n_images, H, W,
                                  cin, cout, npad, kh, kw, limit,
                                  static_cast<cudaStream_t>(stream));
}

// The same conv in f32 on the tensor cores by 3xTF32: x f32 (16-byte
// aligned), the f32 weights packed in the tf32 K-major order
// ([taps][cin/8][npad/8][2][8][4]), cin % 16 == 0, npad at most 160.
int masked_conv_fwd_tf32(const void* x, const void* w, void* out,
                         const int* taps, int ntaps, int n_images, int H,
                         int W, int cin, int cout, int npad, int kh, int kw,
                         size_t limit, void* stream) {
  return wgmma_conv<float, true>(x, w, out, taps, ntaps, n_images, H, W,
                                 cin, cout, npad, kh, kw, limit,
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
