// K2 backward: dgrad and wgrad of one masked stride-1 SAME conv, for Hopper.
//
// Replaces the backward of iaf_tpu/ops/masked_conv.py (_bwd, :98-111),
// which took the VJP of the XLA twin. For the forward
//   out[y, x, co] = sum_t sum_ci in[y + dy_t - ph, x + dx_t - pw, ci] W[t][ci][co]
// and the output gradient G:
//
//   dgrad  dIn[y, x, ci] = sum_t sum_co G[y + (kh-1-dy_t) - ph,
//                                         x + (kw-1-dx_t) - pw, co] W[t][ci][co]
//          the forward's conv (masked_conv.cuh) applied to G with every tap
//          mirrored and the weights transposed per tap ([t][cout][cin]):
//          the mask is causal, so this conv is anti-causal. dx comes out in
//          the input's type.
//   wgrad  dW[t][ci][co] = sum over N*H*W of in[y + dy_t - ph, x + dx_t - pw,
//          ci] G[y, x, co] at the live taps, zeros at the dead ones (JAX's
//          VJP gives nonzero values there, which the fold's mask multiply
//          zeroes before they reach V).
//
// In bf16 the output gradient is rounded to bf16 where it enters a product,
// as the twin's autograd rounds it (the forward output is widened from
// bf16 there).
//
// wgrad is a reduction over N*H*W pixels (8192 at batch 32). Blocks run in
// no order, so it is made deterministic as K1's is: each block owns a chunk
// of image rows, a 32 x 32 (ci x co) tile and a group of TG taps, keeps its
// sums in registers (a warp's lanes are 32 output channels, each holding 4
// input channels x TG taps), writes them as a partial, and a second kernel
// adds the partials in chunk order. The same inputs give the same bits.
//
// Bound on the H100 per 5x5 AR layer at batch 32, paper widths (convs
// 32->160, 160->160, 160->64, 13 live taps): 2 x 8.7 GFLOP (dgrad and
// wgrad) against ~27 MB of compulsory traffic: ~18 us at the bf16 tensor-
// core peak against ~8 us of HBM time, so bound by operations. dgrad runs
// on the tensor cores (the forward's core); wgrad is FP32 FMA on the CUDA
// cores (bf16 operands widened as staged), whose floor is the 67 TFLOP/s
// FMA rate: tensor cores for wgrad are the next step.
//
// Entry points (plain C, loaded with ctypes): masked_conv_dgrad,
// masked_conv_wgrad, masked_conv_wreduce.

#include "masked_conv.cuh"

#define WG_CI 32    // wgrad: input channels per block (8 warps x 4)
#define WG_CO 32    // wgrad: output channels per block (one per lane)
#define WG_THREADS 256
#define TG 8        // wgrad: taps per block

struct WgradArgs {
  const void* x;     // [N,H,W,cin] T conv input
  const float* g;    // [N,H,W,cout] f32 gradient of the conv's output
  float* part;       // [chunks][ntaps][cin][cout] f32 partials
  int H, W, cin, cout, ph, pw, rows, rows_per_chunk;
  int ntaps, dy_lo, dy_hi, co_tiles;
  signed char tap_dy[MAX_TAPS], tap_dx[MAX_TAPS];
};

template <typename T>
__global__ void __launch_bounds__(WG_THREADS)
    conv_wgrad_kernel(WgradArgs a) {
  extern __shared__ __align__(16) float wsm[];
  const int H = a.H, W = a.W, XW = W + 2 * a.pw;
  const int XR = a.dy_hi - a.dy_lo + 1;
  float* xs = wsm;                    // [XR][XW][WG_CI] input rows
  float* gs = wsm + XR * XW * WG_CI;  // [W][WG_CO] gradient row y
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ci0 = blockIdx.y * WG_CI;
  const int co0 = (blockIdx.z % a.co_tiles) * WG_CO;
  const int t0 = (blockIdx.z / a.co_tiles) * TG;
  const int r0 = blockIdx.x * a.rows_per_chunk;
  const int r1 = min(r0 + a.rows_per_chunk, a.rows);
  float acc[TG][4];
#pragma unroll
  for (int u = 0; u < TG; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[u][j] = 0.f;

  for (int r = r0; r < r1; ++r) {
    const int n = r / H, y = r - n * H;
    __syncthreads();
    for (int i = threadIdx.x; i < XR * XW * WG_CI; i += blockDim.x) {
      const int s = i / (XW * WG_CI), rem = i - s * XW * WG_CI;
      const int col = rem / WG_CI, c = rem - col * WG_CI;
      const int yy = y + a.dy_lo - a.ph + s, xx = col - a.pw, ci = ci0 + c;
      float v = 0.f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && ci < a.cin)
        v = to_f(static_cast<const T*>(a.x)[(((size_t)n * H + yy) * W + xx) *
                                                a.cin + ci]);
      xs[i] = v;
    }
    for (int i = threadIdx.x; i < W * WG_CO; i += blockDim.x) {
      const int x = i / WG_CO, c = i - x * WG_CO, co = co0 + c;
      gs[i] = co < a.cout
                  ? to_f(from_f<T>(
                        a.g[(((size_t)n * H + y) * W + x) * a.cout + co]))
                  : 0.f;
    }
    __syncthreads();
    for (int x = 0; x < W; ++x) {
      const float gv = gs[x * WG_CO + lane];
#pragma unroll
      for (int u = 0; u < TG; ++u) {
        const int t = t0 + u;
        if (t >= a.ntaps) break;
        // tap (dy, dx) reads input row y + dy - ph (staged row dy - dy_lo),
        // pixel x + dx - pw (staged column x + dx)
        const float4 xv = *reinterpret_cast<const float4*>(
            xs + (((a.tap_dy[t] - a.dy_lo) * XW) + x + a.tap_dx[t]) * WG_CI +
            4 * warp);
        acc[u][0] = fmaf(xv.x, gv, acc[u][0]);
        acc[u][1] = fmaf(xv.y, gv, acc[u][1]);
        acc[u][2] = fmaf(xv.z, gv, acc[u][2]);
        acc[u][3] = fmaf(xv.w, gv, acc[u][3]);
      }
    }
  }

  const int co = co0 + lane;
  if (co >= a.cout) return;
  float* base = a.part + (size_t)blockIdx.x * a.ntaps * a.cin * a.cout;
#pragma unroll
  for (int u = 0; u < TG; ++u) {
    const int t = t0 + u;
    if (t >= a.ntaps) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + 4 * warp + j;
      if (ci < a.cin) base[((size_t)t * a.cin + ci) * a.cout + co] = acc[u][j];
    }
  }
}

// Sums the partials in chunk order into dW [kh][kw][cin][cout] T: tap
// (dy, dx) takes live tap slot[dy * kw + dx] of the partials, or zeros
// where that is -1.
struct ReduceArgs {
  const float* part;
  void* dw;
  int chunks, ntaps, cin, cout, kk;
  signed char slot[MAX_TAPS];
};

template <typename T>
__global__ void conv_wreduce_kernel(ReduceArgs a) {
  const size_t per_tap = (size_t)a.cin * a.cout;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)a.kk * per_tap) return;
  const int tap = (int)(i / per_tap);
  const size_t rem = i - tap * per_tap;
  const int t = a.slot[tap];
  float s = 0.f;
  if (t >= 0) {
    const size_t stride = (size_t)a.ntaps * per_tap;
    const float* p = a.part + t * per_tap + rem;
    for (int k = 0; k < a.chunks; ++k) s += p[k * stride];
  }
  static_cast<T*>(a.dw)[i] = from_f<T>(s);
}

extern "C" {

// dx [N,H,W,cdx] (T) of the conv, from the f32 output gradient g
// [N,H,W,cg] and the weights transposed per tap, over the ntaps mirrored
// (kh-1-dy, kw-1-dx) pairs of ``taps`` (host array), packed in mma.sync
// fragment order for [taps][cg][cdx] (mma = 1) or as [taps][cg][cdx]
// (mma = 0). Returns cudaGetLastError() after the launch (0 on success).
int masked_conv_dgrad(const void* g, const void* wt, void* dx,
                      const int* taps, int ntaps, int n_images, int H, int W,
                      int cg, int cdx, int kh, int kw, int tr, int bf16,
                      int mma, int threads, void* stream) {
  ConvArgs a;
  int e = conv_prepare(a, g, wt, dx, taps, ntaps, H, W, cg, cdx, kh, kw, tr);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma) {
    if (!bf16 || W % 16 || W > 16 * MT || cg % 16 || cdx % 8 ||
        tr * (W / 16) > MT)
      return (int)cudaErrorInvalidValue;
    return conv_launch(conv_mma_kernel<float, __nv_bfloat16>, a, n_images,
                       kw, 1, threads, s);
  }
  return bf16 ? conv_launch(conv_fma_kernel<float, __nv_bfloat16,
                                            __nv_bfloat16>,
                            a, n_images, kw, 0, threads, s)
              : conv_launch(conv_fma_kernel<float, float, float>, a,
                            n_images, kw, 0, threads, s);
}

// Per-chunk weight-gradient partials [chunks][ntaps][cin][cout] f32 over
// chunks of ``rows_per_chunk`` image rows, for the conv input x (T) and
// the f32 output gradient g, at the ntaps (dy, dx) pairs of ``taps``.
int masked_conv_wgrad(const void* x, const void* g, void* part,
                      const int* taps, int ntaps, int n_images, int H, int W,
                      int cin, int cout, int kh, int kw, int rows_per_chunk,
                      int bf16, void* stream) {
  ConvArgs c;  // for its tap checks and row range
  int e = conv_prepare(c, x, nullptr, part, taps, ntaps, H, W, cin, cout,
                       kh, kw, 1);
  if (e) return e;
  if (rows_per_chunk < 1) return (int)cudaErrorInvalidValue;
  WgradArgs a;
  a.x = x;
  a.g = static_cast<const float*>(g);
  a.part = static_cast<float*>(part);
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.ph = c.ph;
  a.pw = c.pw;
  a.rows = n_images * H;
  a.rows_per_chunk = rows_per_chunk;
  a.ntaps = ntaps;
  a.dy_lo = c.dy_lo;
  a.dy_hi = c.dy_hi;
  a.co_tiles = (cout + WG_CO - 1) / WG_CO;
  for (int t = 0; t < ntaps; ++t) {
    a.tap_dy[t] = c.tap_dy[t];
    a.tap_dx[t] = c.tap_dx[t];
  }
  const size_t smem = ((size_t)(a.dy_hi - a.dy_lo + 1) * (W + 2 * a.pw) *
                           WG_CI +
                       (size_t)W * WG_CO) *
                      sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? conv_wgrad_kernel<__nv_bfloat16>
                     : conv_wgrad_kernel<float>;
  cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid((a.rows + rows_per_chunk - 1) / rows_per_chunk,
                  (cin + WG_CI - 1) / WG_CI,
                  a.co_tiles * ((ntaps + TG - 1) / TG));
  kernel<<<grid, WG_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The partials' sum, in chunk order, into dW [kh][kw][cin][cout] (T),
// zeros at the taps not in ``taps``.
int masked_conv_wreduce(const void* part, void* dw, const int* taps,
                        int ntaps, int chunks, int cin, int cout, int kh,
                        int kw, int bf16, void* stream) {
  if (kh * kw > MAX_TAPS || ntaps < 1 || ntaps > kh * kw)
    return (int)cudaErrorInvalidValue;
  ReduceArgs a;
  a.part = static_cast<const float*>(part);
  a.dw = dw;
  a.chunks = chunks;
  a.ntaps = ntaps;
  a.cin = cin;
  a.cout = cout;
  a.kk = kh * kw;
  for (int i = 0; i < kh * kw; ++i) a.slot[i] = -1;
  for (int t = 0; t < ntaps; ++t) {
    const int dy = taps[2 * t], dx = taps[2 * t + 1];
    if (dy < 0 || dy >= kh || dx < 0 || dx >= kw)
      return (int)cudaErrorInvalidValue;
    a.slot[dy * kw + dx] = (signed char)t;
  }
  const size_t total = (size_t)a.kk * cin * cout;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    conv_wreduce_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(a);
  else
    conv_wreduce_kernel<float><<<blocks, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
