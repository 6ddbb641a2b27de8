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
// Design: conv_wgmma_kernel<N, float, WGS> (masked_conv.cuh; bf16 on the
// tensor cores, 128-pixel tiles, or 64-pixel tiles of one warpgroup where
// the 128-pixel ones leave SMs idle: the launch plan, fwd_plan in
// masked_conv.py), conv_tf32_kernel<N, WGS> (f32 by 3xTF32 on the tensor
// cores, the same tiles) and conv_fma_kernel for the shapes the
// tensor-core kernels do not tile.
//
// Entry points (plain C, loaded with ctypes): masked_conv_smem_bytes and
// masked_conv_fwd (FMA path), masked_conv_wgmma_stages(_tile),
// masked_conv_fwd_wgmma and masked_conv_fwd_tf32 (tensor-core paths),
// masked_conv_pack_w (their weights, packed in one launch) and
// masked_conv_fwd_grid (the tensor-core launch's grid, launching
// nothing).

#include "masked_conv.cuh"

#define PACK_THREADS 256

struct PackArgs {
  const void* w;          // [kh][kw][cin][cout], strides st (elements)
  uint4* out;             // [taps][cin/2E][npad/8][2][8][E]
  long long st[4];
  int cin, cout, npad, units;
  signed char dy[MAX_TAPS], dx[MAX_TAPS];
};

// The tensor-core forward's weights, the live taps only, in wgmma_pack
// order (masked_conv.py fwd_pack, its plain twin: the same bytes), in one
// launch where the twin's gather and packing copy take two. One thread a
// 16-byte core-matrix row: unit i = (((t * cin/2E + s) * npad/8 + j) * 2
// + h) * 8 + n holds the E (bf16: 8, f32: 4) weights of input channels
// 2E s + E h .. + E - 1 for output column 8 j + n of live tap t, zeros
// past cout. Bound by its launch: 665 KB in and out at 160->160 bf16.
template <bool F32>
__global__ void __launch_bounds__(PACK_THREADS) conv_pack_w_kernel(
    PackArgs a) {
  constexpr int E = F32 ? 4 : 8;
  const int i = blockIdx.x * PACK_THREADS + threadIdx.x;
  if (i >= a.units) return;
  const int jn = a.npad / 8, ks = a.cin / (2 * E);
  int r = i;
  const int n = r & 7;
  r >>= 3;
  const int h = r & 1;
  r >>= 1;
  const int j = r % jn;
  r /= jn;
  const int s = r % ks, t = r / ks;
  const int co = 8 * j + n;
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (co < a.cout) {
    const long long off = a.dy[t] * a.st[0] + a.dx[t] * a.st[1] +
                          (2 * E * s + E * h) * a.st[2] + co * a.st[3];
    if constexpr (F32) {
      const float* src = static_cast<const float*>(a.w) + off;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __float_as_uint(src[k * a.st[2]]);
    } else {
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(a.w) + off;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k >> 1] |= (uint32_t)__bfloat16_as_ushort(src[k * a.st[2]])
                     << (16 * (k & 1));
    }
  }
  a.out[i] = make_uint4(v[0], v[1], v[2], v[3]);
}

extern "C" {

// Bytes of dynamic shared memory one FMA-path block of ``tr`` output rows
// asks for (the wrapper picks tr so that this fits the 227 KB a Hopper
// block may use); span = dy_hi - dy_lo of the taps.
size_t masked_conv_smem_bytes(int tr, int W, int cin, int kw, int span) {
  return conv_smem_bytes(tr, W, cin, kw, span);
}

// Ring stages the tensor-core kernel (bf16, or with f32 = 1 the 3xTF32
// instantiation) gets within ``limit`` bytes at this shape (npad: cout
// rounded up to an instantiated width) on tiles of ``tile_pixels`` (128 or
// 64); it takes the shape when this is at least 2. 64-pixel tiles stage
// fewer rows, so a shape that fits at 128 fits at 64 with at least as
// many stages.
int masked_conv_wgmma_stages_tile(int W, int cin, int kw, int span, int npad,
                                  int ntaps, size_t limit, int f32,
                                  int tile_pixels) {
  const int tr = tile_pixels == 64 || tile_pixels == 128
                     ? wg_tile_rows(W, tile_pixels / 16)
                     : 0;
  return tr ? wg_plan(tr, W, cin, kw, span, npad, ntaps, limit, f32).stages
            : 0;
}

// The same on 128-pixel tiles: what the routes (``_route`` in
// masked_conv.py) decide on.
int masked_conv_wgmma_stages(int W, int cin, int kw, int span, int npad,
                             int ntaps, size_t limit, int f32) {
  return masked_conv_wgmma_stages_tile(W, cin, kw, span, npad, ntaps, limit,
                                       f32, 128);
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
// zero-padded to npad, on tiles of ``tile_pixels`` (128 or 64); see
// wgmma_conv.
int masked_conv_fwd_wgmma(const void* x, const void* w, void* out,
                          const int* taps, int ntaps, int n_images, int H,
                          int W, int cin, int cout, int npad, int kh, int kw,
                          int tile_pixels, size_t limit, void* stream) {
  return wgmma_conv<float, false>(x, w, out, taps, ntaps, n_images, H, W,
                                  cin, cout, npad, kh, kw, limit, tile_pixels,
                                  static_cast<cudaStream_t>(stream));
}

// The same conv in f32 on the tensor cores by 3xTF32: x f32 (16-byte
// aligned), the f32 weights packed in the tf32 K-major order
// ([taps][cin/8][npad/8][2][8][4]), cin % 16 == 0, npad at most 160.
int masked_conv_fwd_tf32(const void* x, const void* w, void* out,
                         const int* taps, int ntaps, int n_images, int H,
                         int W, int cin, int cout, int npad, int kh, int kw,
                         int tile_pixels, size_t limit, void* stream) {
  return wgmma_conv<float, true>(x, w, out, taps, ntaps, n_images, H, W,
                                 cin, cout, npad, kh, kw, limit, tile_pixels,
                                 static_cast<cudaStream_t>(stream));
}

// ``w`` [kh][kw][cin][cout] (bf16, or f32 with ``f32``; ``strides`` its
// four strides in elements) packed for the tensor-core forward into
// ``out`` (16-byte aligned): the ntaps (dy, dx) pairs of ``taps`` (host
// array), each [cin/2E][npad/8][2][8][E], E = 8 (f32: 4); cin % 2E == 0,
// npad % 8 == 0, cout <= npad.
int masked_conv_pack_w(const void* w, void* out, const int* taps, int ntaps,
                       int kh, int kw, int cin, int cout, int npad,
                       const long long* strides, int f32, void* stream) {
  const int e = f32 ? 4 : 8;
  if (ntaps < 1 || ntaps > MAX_TAPS || cin % (2 * e) || npad % 8 ||
      cout > npad || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  PackArgs a;
  a.w = w;
  a.out = static_cast<uint4*>(out);
  for (int k = 0; k < 4; ++k) a.st[k] = strides[k];
  a.cin = cin;
  a.cout = cout;
  a.npad = npad;
  a.units = ntaps * (cin / (2 * e)) * (npad / 8) * 16;
  for (int t = 0; t < ntaps; ++t) {
    const int dy = taps[2 * t], dx = taps[2 * t + 1];
    if (dy < 0 || dy >= kh || dx < 0 || dx >= kw)
      return (int)cudaErrorInvalidValue;
    a.dy[t] = (signed char)dy;
    a.dx[t] = (signed char)dx;
  }
  const int blocks = (a.units + PACK_THREADS - 1) / PACK_THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    conv_pack_w_kernel<true><<<blocks, PACK_THREADS, 0, s>>>(a);
  else
    conv_pack_w_kernel<false><<<blocks, PACK_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The grid that masked_conv_fwd_wgmma (f32 = 0) or masked_conv_fwd_tf32
// (f32 = 1) would launch with these arguments, launching nothing: grid[0]
// the blocks, grid[1] the blocks resident on one SM (1: no two blocks of
// the grid share an SM). Sets the kernel's shared-memory attribute as the
// launch does.
int masked_conv_fwd_grid(const void* x, const void* w, const int* taps,
                         int ntaps, int n_images, int H, int W, int cin,
                         int cout, int npad, int kh, int kw, int tile_pixels,
                         size_t limit, int f32, int* grid) {
  return f32 ? wgmma_conv<float, true>(x, w, nullptr, taps, ntaps, n_images,
                                       H, W, cin, cout, npad, kh, kw, limit,
                                       tile_pixels, nullptr, grid)
             : wgmma_conv<float, false>(x, w, nullptr, taps, ntaps, n_images,
                                        H, W, cin, cout, npad, kh, kw, limit,
                                        tile_pixels, nullptr, grid);
}

}  // extern "C"
