// K2's implicit-GEMM core: one stride-1 SAME conv over a given list of live
// taps, NHWC in and out. masked_conv.cu instantiates the FMA kernel for the
// forward conv in f32 and on shapes its tensor-core kernel does not tile
// (that kernel, conv_wgmma_kernel, lives in masked_conv.cu);
// masked_conv_bwd.cu instantiates both for dgrad (the conv of the output
// gradient with the taps mirrored and the weights transposed per tap).
//
// out[n, y, x, co] = sum over taps t, ci of
//     in[n, y + dy_t - ph, x + dx_t - pw, ci] * W[t][ci][co]
// with ph = (kh - 1) / 2, pw = (kw - 1) / 2 and zeros outside the image.
//
// A block owns `tr` output rows of one image (every column, every output
// channel). It stages the input rows those rows read, y0 + dy_lo - ph to
// y0 + tr - 1 + dy_hi - ph (dy_lo, dy_hi: the taps' row range), with a pw
// column halo on each side, in shared memory once; zeros stand for the SAME
// padding, so no padded copy exists in device memory. Then it accumulates
// over (tap, channel step) with the weights read from L2:
//
// * conv_mma_kernel, dgrad only (the forward runs conv_wgmma_kernel; this
//   one goes when dgrad and wgrad move to wgmma), bf16 operands on the
//   tensor cores (mma.sync m16n8k16, f32 accumulate): the input is rounded to bf16 as it is staged, with the
//   channel stride padded by CPAD so a fragment's 8 pixel rows fall in
//   distinct banks. The block's tr * W/16 16-pixel M tiles (at most MT)
//   are each warp's whole share of M: a warp owns a pair of 8-wide output
//   tiles, keeps MT x 2 accumulator tiles in registers, and every B
//   fragment it loads (weights packed in fragment order, as K1's) feeds MT
//   M tiles.
// * conv_fma_kernel, FP32 FMA on the CUDA cores (f32, whose tolerance TF32
//   would break, and shapes the tensor-core path does not tile): the input
//   is staged as f32 after rounding to the weights' type, one thread item
//   is one output channel of PX neighbouring pixels, activations broadcast
//   from shared memory, weights ([taps][cin][cout]) coalesced across output
//   channels.
//
// Types: Tin is the input's (T for the forward, f32 for dgrad's output
// gradient), Tw the weights', Tout the output's (f32 for the forward, T for
// dgrad's dx); accumulation is f32.

#pragma once

#include "common.cuh"

#define MAX_TAPS 64
#define CPAD 8
#define MT 8            // tensor-core path: 16-pixel M tiles per block
#define KU 4            // tensor-core path: k-steps of B loaded ahead
#define MMA_THREADS 320 // tensor-core path: at most 10 warps (pairs of tiles)
#define PX 8            // FMA path: output pixels per thread item
#define FMA_THREADS 256

struct ConvArgs {
  const void* in;    // [N,H,W,cin] Tin
  const void* w;     // packed weights, Tw
  void* out;         // [N,H,W,cout] Tout
  int H, W, cin, cout, ph, pw;
  int ntaps, dy_lo, dy_hi, tr;
  signed char tap_dy[MAX_TAPS], tap_dx[MAX_TAPS];
};

// Staged columns per row: the image with its pw halo on both sides (and,
// on the FMA path, room for the last pixel group's reads past W).
__host__ __device__ static inline int staged_cols(int W, int kw, int mma) {
  return (mma ? W : (W + PX - 1) / PX * PX) + kw - 1;
}

// Dynamic shared memory of one block: (tr + dy_hi - dy_lo) staged rows.
static size_t conv_smem_bytes(int tr, int W, int cin, int kw, int span,
                              int mma) {
  const size_t pixels = (size_t)(tr + span) * staged_cols(W, kw, mma);
  return mma ? pixels * (cin + CPAD) * 2 : pixels * cin * 4;
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(MMA_THREADS)
    conv_mma_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int H = a.H, W = a.W, cin = a.cin, cs = cin + CPAD;
  const int SC = staged_cols(W, 2 * a.pw + 1, 1);
  const int SR = a.tr + a.dy_hi - a.dy_lo;
  const int tiles_y = (H + a.tr - 1) / a.tr;
  const int n = blockIdx.x / tiles_y, y0 = (blockIdx.x - n * tiles_y) * a.tr;
  const int row0 = y0 + a.dy_lo - a.ph;  // image row of staged row 0

  const Tin* __restrict__ in =
      static_cast<const Tin*>(a.in) + (size_t)n * H * W * cin;
  for (int i = threadIdx.x; i < SR * SC * cin; i += blockDim.x) {
    const int r = i / (SC * cin), rem = i - r * SC * cin;
    const int c = rem / cin, ci = rem - c * cin;
    const int yy = row0 + r, xx = c - a.pw;
    float v = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = to_f(in[((size_t)yy * W + xx) * cin + ci]);
    xs[((size_t)r * SC + c) * cs + ci] = __float2bfloat16(v);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int ntiles = a.cout / 8, ksteps = cin / 16;
  const int segs = W / 16, mtiles = a.tr * segs;
  const uint2* __restrict__ wf = static_cast<const uint2*>(a.w);

  for (int pair = warp; pair * 2 < ntiles; pair += nwarps) {
    const bool has1 = pair * 2 + 1 < ntiles;
    float acc[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;

    for (int t = 0; t < a.ntaps; ++t) {
      const int dy = a.tap_dy[t] - a.dy_lo, dx = a.tap_dx[t];
      const uint2* w0 =
          wf + ((size_t)(t * ntiles + pair * 2) * ksteps) * 32 + lane;
      const uint2* w1 = w0 + (size_t)ksteps * 32;
      for (int kb = 0; kb < ksteps; kb += KU) {
        uint2 b0[KU], b1[KU];
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          b0[u] = b1[u] = make_uint2(0u, 0u);
          if (kb + u < ksteps) {
            b0[u] = __ldg(w0 + (kb + u) * 32);
            if (has1) b1[u] = __ldg(w1 + (kb + u) * 32);
          }
        }
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          if (kb + u >= ksteps) break;
          const int k0 = (kb + u) * 16 + 2 * tig;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m >= mtiles) break;
            const int ry = m / segs, sx = (m - ry * segs) * 16;
            // output pixel (y0 + ry, sx + g) reads staged row ry + dy,
            // staged column sx + g + dx
            const __nv_bfloat16* ab =
                xs + ((size_t)(ry + dy) * SC + sx + g + dx) * cs + k0;
            uint32_t af[4];
            af[0] = lds32(ab);
            af[1] = lds32(ab + 8 * cs);
            af[2] = lds32(ab + 8);
            af[3] = lds32(ab + 8 * cs + 8);
            mma_16816(acc[m][0], af, b0[u].x, b0[u].y);
            if (has1) mma_16816(acc[m][1], af, b1[u].x, b1[u].y);
          }
        }
      }
    }

#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= mtiles) break;
      const int ry = m / segs, sx = (m - ry * segs) * 16, y = y0 + ry;
      if (y >= H) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j == 1 && !has1) break;
        const int co = (pair * 2 + j) * 8 + 2 * tig;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = sx + g + half * 8;
          const size_t idx = (((size_t)n * H + y) * W + x) * a.cout + co;
          const float v0 = acc[m][j][2 * half], v1 = acc[m][j][2 * half + 1];
          if (sizeof(Tout) == 4)
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + idx) =
                make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(a.out) + idx) =
                __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <typename Tin, typename Tw, typename Tout>
__global__ void __launch_bounds__(FMA_THREADS) conv_fma_kernel(ConvArgs a) {
  extern __shared__ __align__(16) float fs[];
  const int H = a.H, W = a.W, cin = a.cin, cout = a.cout;
  const int SC = staged_cols(W, 2 * a.pw + 1, 0);
  const int SR = a.tr + a.dy_hi - a.dy_lo;
  const int tiles_y = (H + a.tr - 1) / a.tr;
  const int n = blockIdx.x / tiles_y, y0 = (blockIdx.x - n * tiles_y) * a.tr;
  const int row0 = y0 + a.dy_lo - a.ph;

  const Tin* __restrict__ in =
      static_cast<const Tin*>(a.in) + (size_t)n * H * W * cin;
  for (int i = threadIdx.x; i < SR * SC * cin; i += blockDim.x) {
    const int r = i / (SC * cin), rem = i - r * SC * cin;
    const int c = rem / cin, ci = rem - c * cin;
    const int yy = row0 + r, xx = c - a.pw;
    float v = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = to_f(from_f<Tw>(to_f(in[((size_t)yy * W + xx) * cin + ci])));
    fs[i] = v;
  }
  __syncthreads();

  const Tw* __restrict__ wt = static_cast<const Tw*>(a.w);
  const int ngroups = (W + PX - 1) / PX;
  const int items = a.tr * ngroups * cout;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int co = item % cout, rest = item / cout;
    const int grp = rest % ngroups, ry = rest / ngroups;
    const int y = y0 + ry, x0 = grp * PX;
    if (y >= H) continue;
    float acc[PX];
#pragma unroll
    for (int q = 0; q < PX; ++q) acc[q] = 0.f;
    for (int t = 0; t < a.ntaps; ++t) {
      const int dy = a.tap_dy[t] - a.dy_lo, dx = a.tap_dx[t];
      const float* arow = fs + ((size_t)(ry + dy) * SC + x0 + dx) * cin;
      const Tw* wcol = wt + (size_t)t * cin * cout + co;
      for (int ci = 0; ci < cin; ++ci) {
        const float wv = to_f(wcol[(size_t)ci * cout]);
#pragma unroll
        for (int q = 0; q < PX; ++q)
          acc[q] = fmaf(arow[q * cin + ci], wv, acc[q]);
      }
    }
    Tout* out = static_cast<Tout*>(a.out);
#pragma unroll
    for (int q = 0; q < PX; ++q) {
      const int x = x0 + q;
      if (x >= W) break;
      out[(((size_t)n * H + y) * W + x) * cout + co] = from_f<Tout>(acc[q]);
    }
  }
}

// Fills the tap fields of ``a`` from ``taps`` (ntaps (dy, dx) pairs) and
// checks the launch; returns 0 or a cudaError_t.
static int conv_prepare(ConvArgs& a, const void* in, const void* w,
                        void* out, const int* taps, int ntaps, int H, int W,
                        int cin, int cout, int kh, int kw, int tr) {
  if (ntaps < 1 || ntaps > MAX_TAPS || tr < 1 || kh % 2 == 0 || kw % 2 == 0)
    return (int)cudaErrorInvalidValue;
  a.in = in;
  a.w = w;
  a.out = out;
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.ph = (kh - 1) / 2;
  a.pw = (kw - 1) / 2;
  a.ntaps = ntaps;
  a.tr = tr;
  a.dy_lo = kh;
  a.dy_hi = -1;
  for (int t = 0; t < ntaps; ++t) {
    const int dy = taps[2 * t], dx = taps[2 * t + 1];
    if (dy < 0 || dy >= kh || dx < 0 || dx >= kw)
      return (int)cudaErrorInvalidValue;
    a.tap_dy[t] = (signed char)dy;
    a.tap_dx[t] = (signed char)dx;
    a.dy_lo = dy < a.dy_lo ? dy : a.dy_lo;
    a.dy_hi = dy > a.dy_hi ? dy : a.dy_hi;
  }
  return 0;
}

template <typename Kernel>
static int conv_launch(Kernel kernel, const ConvArgs& a, int n_images,
                       int kw, int mma, int threads, cudaStream_t stream) {
  const size_t smem =
      conv_smem_bytes(a.tr, a.W, a.cin, kw, a.dy_hi - a.dy_lo, mma);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = n_images * ((a.H + a.tr - 1) / a.tr);
  kernel<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
