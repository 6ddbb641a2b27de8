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
// bf16 there): on the tensor cores the wrapper rounds it once (for dgrad
// to bf16 NHWC, for wgrad into wgmma's B layout).
//
// Bound on the H100 per 5x5 AR layer at batch 32, paper widths (convs
// 32->160, 160->160, 160->64, 13 live taps): 2 x 8.7 GFLOP (dgrad and
// wgrad) against ~27 MB of compulsory traffic: ~18 us at the bf16 tensor-
// core peak against ~8 us of HBM time, so bound by operations.
//
// Design, bf16:
// * dgrad runs the forward's tensor-core kernel, conv_wgmma_kernel<N,
//   bf16> (masked_conv.cuh), on G in bf16 with the mirrored taps.
// * wgrad is a GEMM per conv, M = taps x cin rows (t, ci), N = cout, K =
//   the N*H*W pixels, on wgmma (conv_wgrad_wgmma_kernel): A from
//   registers, gathered from the input's staged rows by ldmatrix.trans
//   (each lane gives the 16-byte channel row of its own shifted pixel, the
//   forward's implicit-GEMM trick with pixels as K), B from shared memory,
//   G's 128-pixel slice packed by the wrapper in the canonical K-major
//   layout (the forward's weight layout with pixels as K). Both are staged
//   with 16-byte cp.async, double-buffered. A block owns a chunk of
//   128-pixel sub-tiles and 128 rows of M (a warpgroup 64): 4 taps of one
//   32-channel block, so it stages only those 32 channels of its rows
//   (the kernel is bound by these reads from L2, not by wgmma). It keeps
//   its sums in registers over the chunk and writes them as an f32
//   partial.
// wgrad is a reduction over N*H*W pixels (8192 at batch 32), and blocks run
// in no order, so it is made deterministic as K1's is: each block writes
// the partial of its pixel chunk, and conv_wreduce_kernel adds the
// partials in chunk order. The same inputs give the same bits. The wrapper
// picks the chunk count so that chunks x M blocks fill the SMs once.
//
// Design, f32 (the f32 recipe), on the tensor cores by 3xTF32 (each f32
// product lo*hi + hi*lo + hi*hi of tf32 parts, as in masked_conv.cuh):
// * dgrad runs the forward's conv_tf32_kernel<N> on G in f32 with the
//   mirrored taps, the transposed weights packed in the tf32
//   K-major order; dx comes out in f32.
// * wgrad is the same GEMM (conv_wgrad_tf32_kernel). wgmma takes tf32
//   operands K-major only, and K is the pixels: ldmatrix.trans moves
//   16-bit elements and would split f32 words. So B, G, gets its pixels
//   contiguous from the wrapper's one packing copy (the tf32 K-major layout
//   with pixels as K) and is split on chip (each block splits its landed
//   slice in place, hi over it, lo after it); A, the input's staged rows,
//   keeps channels contiguous and each lane reads its fragment's four
//   floats itself, bank-conflict free with a channel stride of GW_CB + 8
//   floats, and splits them in registers. f32 halves the pixels a stage
//   holds (64-pixel sub-tiles, G's hi and lo: two stages are 202 KB at
//   cout = 160); every GT_GROUP k8 steps (12 wgmmas) the tensor cores' sum
//   goes into f32 totals (K per chunk is ~1400 pixels at batch 32).
// Bound, f32, per 5x5 AR layer at batch 32: 3 x 17.4 GFLOP of TF32
// products, 0.105 ms at 495 TFLOP/s (any exact-f32 CUDA-core kernel: 0.26
// ms at 67 TFLOP/s).
//
// Shapes the tensor-core kernels do not tile, bf16 or f32: dgrad on
// conv_fma_kernel, wgrad on conv_wgrad_kernel (FP32 FMA: each block owns a
// chunk of image rows, a 32 x 32 (ci x co) tile and a group of TG taps,
// keeps its sums in registers, a warp's lanes being 32 output channels,
// each holding 4 input channels x TG taps), both through the same partials
// and reduce.
//
// Entry points (plain C, loaded with ctypes): masked_conv_dgrad,
// masked_conv_dgrad_wgmma, masked_conv_dgrad_tf32, masked_conv_wgrad,
// masked_conv_wgrad_wgmma_smem, masked_conv_wgrad_wgmma,
// masked_conv_wgrad_tf32_smem, masked_conv_wgrad_tf32 (also the way onto
// the tensor cores for K1's f32 backward), masked_conv_wreduce.

#include "masked_conv.cuh"

#define FW_CI 32    // FMA wgrad: input channels per block (8 warps x 4)
#define FW_CO 32    // FMA wgrad: output channels per block (one per lane)
#define FW_THREADS 256
#define TG 8        // FMA wgrad: taps per block

struct WgradArgs {
  const void* x;     // [N,H,W,cin] T conv input
  const float* g;    // [N,H,W,cout] f32 gradient of the conv's output
  float* part;       // [chunks][ntaps][cin][cout] f32 partials
  int H, W, cin, cout, ph, pw, rows, rows_per_chunk;
  int ntaps, dy_lo, dy_hi, co_tiles;
  signed char tap_dy[MAX_TAPS], tap_dx[MAX_TAPS];
};

template <typename T>
__global__ void __launch_bounds__(FW_THREADS)
    conv_wgrad_kernel(WgradArgs a) {
  extern __shared__ __align__(16) float wsm[];
  const int H = a.H, W = a.W, XW = W + 2 * a.pw;
  const int XR = a.dy_hi - a.dy_lo + 1;
  float* xs = wsm;                    // [XR][XW][FW_CI] input rows
  float* gs = wsm + XR * XW * FW_CI;  // [W][FW_CO] gradient row y
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ci0 = blockIdx.y * FW_CI;
  const int co0 = (blockIdx.z % a.co_tiles) * FW_CO;
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
    for (int i = threadIdx.x; i < XR * XW * FW_CI; i += blockDim.x) {
      const int s = i / (XW * FW_CI), rem = i - s * XW * FW_CI;
      const int col = rem / FW_CI, c = rem - col * FW_CI;
      const int yy = y + a.dy_lo - a.ph + s, xx = col - a.pw, ci = ci0 + c;
      float v = 0.f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && ci < a.cin)
        v = to_f(static_cast<const T*>(a.x)[(((size_t)n * H + yy) * W + xx) *
                                                a.cin + ci]);
      xs[i] = v;
    }
    for (int i = threadIdx.x; i < W * FW_CO; i += blockDim.x) {
      const int x = i / FW_CO, c = i - x * FW_CO, co = co0 + c;
      gs[i] = co < a.cout
                  ? to_f(from_f<T>(
                        a.g[(((size_t)n * H + y) * W + x) * a.cout + co]))
                  : 0.f;
    }
    __syncthreads();
    for (int x = 0; x < W; ++x) {
      const float gv = gs[x * FW_CO + lane];
#pragma unroll
      for (int u = 0; u < TG; ++u) {
        const int t = t0 + u;
        if (t >= a.ntaps) break;
        // tap (dy, dx) reads input row y + dy - ph (staged row dy - dy_lo),
        // pixel x + dx - pw (staged column x + dx)
        const float4 xv = *reinterpret_cast<const float4*>(
            xs + (((a.tap_dy[t] - a.dy_lo) * XW) + x + a.tap_dx[t]) * FW_CI +
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

#define RD_THREADS 256
#define RD_ITEMS 4      // reduce: outputs per thread, RD_THREADS apart

// Sums the partials in chunk order into dW [kh*kw][cin][cout] T: kernel
// position blockIdx.y takes live tap slot[blockIdx.y] of the partials, or
// zeros where that is -1. A block covers RD_THREADS * RD_ITEMS consecutive
// outputs of one position, so every load is coalesced and each thread
// keeps RD_ITEMS loads in flight.
template <typename T>
__global__ void __launch_bounds__(RD_THREADS)
    conv_wreduce_kernel(const float* __restrict__ part, T* __restrict__ dw,
                        const int* __restrict__ slot, int chunks, int ntaps,
                        int per_tap) {
  const int pos = blockIdx.y, t = __ldg(slot + pos);
  const int i0 = blockIdx.x * RD_THREADS * RD_ITEMS + threadIdx.x;
  float s[RD_ITEMS];
#pragma unroll
  for (int j = 0; j < RD_ITEMS; ++j) s[j] = 0.f;
  if (t >= 0) {
    const size_t stride = (size_t)ntaps * per_tap;
    const float* __restrict__ p = part + (size_t)t * per_tap;
    for (int k = 0; k < chunks; ++k, p += stride)
#pragma unroll
      for (int j = 0; j < RD_ITEMS; ++j) {
        const int i = i0 + j * RD_THREADS;
        if (i < per_tap) s[j] += p[i];
      }
  }
#pragma unroll
  for (int j = 0; j < RD_ITEMS; ++j) {
    const int i = i0 + j * RD_THREADS;
    if (i < per_tap) dw[(size_t)pos * per_tap + i] = from_f<T>(s[j]);
  }
}

#define GW_PIXELS 128   // wgmma wgrad: pixels per sub-tile (8 k16 steps)
#define GW_KSTEPS (GW_PIXELS / 16)
#define GW_CB 32        // wgmma wgrad: input channels per block
#define GW_TG 4         // wgmma wgrad: taps per block (two warps a tap)

#define GT_PIXELS 64    // 3xTF32 wgrad: pixels per sub-tile (8 k8 steps)
#define GT_KSTEPS (GT_PIXELS / 8)
#define GT_GROUP 4      // 3xTF32 wgrad: k8 steps per flush (12 wgmmas)
#define GT_CS (GW_CB + 8)   // 3xTF32 wgrad: staged channel stride, floats

struct WgradWgArgs {
  const void* x;            // [N,H,W,cin] conv input (bf16; f32)
  const void* gp;           // G packed: [N*H*W/16][npad/8][2][8][8] bf16
                            // (f32: [N*H*W/8][npad/8][2][8][4])
  float* part;              // [chunks][ntaps * cin][cout] f32 partials
  int H, W, cin, cout, ph, pw, ntaps, dy_lo, dy_hi, tr;
  int n_sub, sub_per_chunk;
  signed char tap_dy[MAX_TAPS], tap_dx[MAX_TAPS];
};

// Bytes of one stage of conv_wgrad_wgmma_kernel: the sub-tile's staged
// input rows (the block's GW_CB channels), then its packed G slice.
__host__ __device__ static inline int gw_stage_bytes(int tr, int W, int kw,
                                                     int span, int npad) {
  return wg_a_bytes(tr, W, GW_CB, kw, span) + GW_PIXELS * npad * 2;
}

// A block's 128 rows of M are GW_TG taps x one block of GW_CB input
// channels (blockIdx.y = channel block x tap groups + tap group), so it
// stages only those channels of its rows (tap rows past ntaps are
// computed and not stored). Sub-tile s is rows tr*(s % (H/tr)) .. + tr -
// 1 of image s / (H/tr): the 128 pixels (s*128 .. s*128 + 127) in NHWC
// order, k-steps 8s .. 8s + 7 of the packed G.
template <int N>
__global__ void __launch_bounds__(WG_CONSUMERS, 1)
    conv_wgrad_wgmma_kernel(WgradWgArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, cin = a.cin, cs = GW_CB + CPAD;
  const int kw = 2 * a.pw + 1, span = a.dy_hi - a.dy_lo;
  const int SC = staged_cols(W, kw, 1);
  const int SR = a.tr + span;
  const int a_bytes = wg_a_bytes(a.tr, W, GW_CB, kw, span);
  const int st_bytes = gw_stage_bytes(a.tr, W, kw, span, N);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int M = a.ntaps * cin;
  const int s0 = blockIdx.x * a.sub_per_chunk;
  const int s1 = min(s0 + a.sub_per_chunk, a.n_sub);

  zero_halo(smem, SR, SC, W, cs, a.pw, tid, WG_CONSUMERS);
  zero_halo(smem + st_bytes, SR, SC, W, cs, a.pw, tid, WG_CONSUMERS);
  __syncthreads();

  // this warp's 16 rows of M: tap t, channels ci .. ci + 15, staged
  // channels c0 .. c0 + 15 (a tap past ntaps reads tap 0 and is not
  // stored)
  const int tgroups = (a.ntaps + GW_TG - 1) / GW_TG;
  const int cb = blockIdx.y / tgroups;
  const int t_w = (blockIdx.y - cb * tgroups) * GW_TG + warp / 2;
  const bool live = t_w < a.ntaps;
  const int t = live ? t_w : 0, c0 = (warp & 1) * 16, ci = cb * GW_CB + c0;
  // ldmatrix.x4.trans: lane l gives pixel (l & 7) + 8 (l >> 4) of the
  // k-step at channel c0 + 8 ((l >> 3) & 1), shifted by tap t (staged row
  // dy_t - dy_lo, staged column dx_t)
  const int lane_off =
      (((a.tap_dy[t] - a.dy_lo) * SC + a.tap_dx[t] + (lane & 7) +
        ((lane >> 4) << 3)) * cs + c0 + ((lane >> 3) & 1) * 8) * 2;
  const int segs = W / 16, tiles_y = H / a.tr;
  const RowCopy copy(tid, WG_CONSUMERS, GW_CB, W);
  const int g_chunks = GW_PIXELS * N * 2 / 16;

  auto stage = [&](int s, int buf) {
    unsigned char* b = smem + buf * st_bytes;
    const int n = s / tiles_y, y0 = (s - n * tiles_y) * a.tr;
    copy.rows(smem_u32(b),
              static_cast<const __nv_bfloat16*>(a.x) + (size_t)n * H * W * cin
                  + cb * GW_CB, cin, y0 + a.dy_lo - a.ph, SR, H, W, SC, cs,
              a.pw);
    const uint32_t gdst = smem_u32(b + a_bytes);
    const unsigned char* gsrc = static_cast<const unsigned char*>(a.gp) +
                                (size_t)s * GW_PIXELS * N * 2;
    for (int i = tid; i < g_chunks; i += WG_CONSUMERS)
      cp_async16(gdst + i * 16, gsrc + i * 16, 16);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  if (s0 < s1) stage(s0, 0);
  int buf = 0;
  for (int s = s0; s < s1; ++s, buf ^= 1) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // the sub-tile has landed; the other stage is free
    if (s + 1 < s1) stage(s + 1, buf ^ 1);
    const uint32_t abase = smem_u32(smem + buf * st_bytes) + lane_off;
    const uint32_t gbase = smem_u32(smem + buf * st_bytes + a_bytes);
    uint32_t af[GW_KSTEPS][4];
#pragma unroll
    for (int i = 0; i < GW_KSTEPS; ++i) {
      const int ry = i / segs, sx = (i - ry * segs) * 16;
      ldmatrix_x4_trans(af[i], abase + (ry * SC + sx) * cs * 2);
    }
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < GW_KSTEPS; ++i)
      wgmma_rs<N>(acc, af[i], b_desc(gbase + i * 16 * N * 2));
    wgmma_commit();
    wgmma_wait0();
  }

  if (!live) return;
  const int g = lane >> 2, tig = lane & 3;
  float* out =
      a.part + ((size_t)blockIdx.x * M + (size_t)t * cin + ci + g) * a.cout;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int co = j * 8 + 2 * tig;
    if (co < a.cout) {
      *reinterpret_cast<float2*>(out + co) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(out + 8 * a.cout + co) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// Bytes of the 3xTF32 wgrad's staged input rows (the block's GW_CB
// channels, f32, GT_CS apart) and of one stage: the rows, then G's
// 64-pixel slice as it lands (its hi part written over it) and its lo part.
__host__ __device__ static inline int gt_x_bytes(int tr, int W, int kw,
                                                 int span) {
  return round128((tr + span) * staged_cols(W, kw, 1) * GT_CS * 4);
}
__host__ __device__ static inline int gt_stage_bytes(int tr, int W, int kw,
                                                     int span, int npad) {
  return gt_x_bytes(tr, W, kw, span) + 2 * GT_PIXELS * npad * 4;
}

// Rows of a 64-pixel sub-tile at width W, or 0 where it is not whole rows
// (W of 16, 32 or 64).
__host__ __device__ static inline int gt_tile_rows(int W) {
  if (W < 16 || W % 16 || GT_PIXELS % W) return 0;
  return GT_PIXELS / W;
}

// The wgrad GEMM in f32 by 3xTF32, blocks as conv_wgrad_wgmma_kernel's
// (GW_TG taps x GW_CB channels of M, a chunk of sub-tiles), with 64-pixel
// sub-tiles: sub-tile s is rows tr*(s % (H/tr)) .. + tr - 1 of image
// s / (H/tr), k8 steps 8s .. 8s + 7 of the packed G.
template <int N>
__global__ void __launch_bounds__(WG_CONSUMERS, 1)
    conv_wgrad_tf32_kernel(WgradWgArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, cin = a.cin;
  const int kw = 2 * a.pw + 1, span = a.dy_hi - a.dy_lo;
  const int SC = staged_cols(W, kw, 1);
  const int SR = a.tr + span;
  const int x_bytes = gt_x_bytes(a.tr, W, kw, span);
  const int st_bytes = gt_stage_bytes(a.tr, W, kw, span, N);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int M = a.ntaps * cin;
  const int s0 = blockIdx.x * a.sub_per_chunk;
  const int s1 = min(s0 + a.sub_per_chunk, a.n_sub);

  // the rows are staged as 2-byte units (an f32 channel is two)
  zero_halo(smem, SR, SC, W, GT_CS * 2, a.pw, tid, WG_CONSUMERS);
  zero_halo(smem + st_bytes, SR, SC, W, GT_CS * 2, a.pw, tid, WG_CONSUMERS);
  __syncthreads();

  // this warp's 16 rows of M: tap t, channels ci .. ci + 15, staged
  // channels c0 .. c0 + 15 (a tap past ntaps reads tap 0 and is not
  // stored)
  const int tgroups = (a.ntaps + GW_TG - 1) / GW_TG;
  const int cb = blockIdx.y / tgroups;
  const int t_w = (blockIdx.y - cb * tgroups) * GW_TG + warp / 2;
  const bool live = t_w < a.ntaps;
  const int t = live ? t_w : 0, c0 = (warp & 1) * 16, ci = cb * GW_CB + c0;
  const int g = lane >> 2, tig = lane & 3;
  // the m16n8k8 tf32 A fragment of a k8 step at pixel p: a0 channel c0 + g
  // at pixel p + tig, a1 channel + 8, a2 and a3 the same at pixel + 4, each
  // read from the staged rows shifted by tap t (staged row dy_t - dy_lo,
  // column dx_t); with channels GT_CS = 40 floats apart the 32 lanes' reads
  // fall in 32 distinct banks
  const int lane_off =
      ((a.tap_dy[t] - a.dy_lo) * SC + a.tap_dx[t] + tig) * GT_CS + c0 + g;
  const int tiles_y = H / a.tr;
  const RowCopy copy(tid, WG_CONSUMERS, GW_CB * 2, W);
  const int g_chunks = GT_PIXELS * N * 4 / 16;
  const __nv_bfloat16* __restrict__ x =
      static_cast<const __nv_bfloat16*>(a.x);

  auto stage = [&](int s, int buf) {
    unsigned char* b = smem + buf * st_bytes;
    const int n = s / tiles_y, y0 = (s - n * tiles_y) * a.tr;
    copy.rows(smem_u32(b), x + ((size_t)n * H * W * cin + cb * GW_CB) * 2,
              cin * 2, y0 + a.dy_lo - a.ph, SR, H, W, SC, GT_CS * 2, a.pw);
    const uint32_t gdst = smem_u32(b + x_bytes);
    const unsigned char* gsrc = static_cast<const unsigned char*>(a.gp) +
                                (size_t)s * GT_PIXELS * N * 4;
    for (int i = tid; i < g_chunks; i += WG_CONSUMERS)
      cp_async16(gdst + i * 16, gsrc + i * 16, 16);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[N / 2], tot[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) tot[i] = 0.f;
  if (s0 < s1) stage(s0, 0);
  int buf = 0;
  for (int s = s0; s < s1; ++s, buf ^= 1) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // the sub-tile has landed; the other stage is free
    unsigned char* b = smem + buf * st_bytes;
    // G's slice into tf32 parts: hi in place, lo after it
    tf32_split_slice(b + x_bytes, GT_PIXELS * N, tid, WG_CONSUMERS);
    fence_proxy_async();
    __syncthreads();   // the split slice is ready for the tensor cores
    if (s + 1 < s1) stage(s + 1, buf ^ 1);
    const float* xs = reinterpret_cast<const float*>(b) + lane_off;
    const uint32_t gbase = smem_u32(b + x_bytes);
#pragma unroll 1
    for (int q = 0; q < GT_KSTEPS / GT_GROUP; ++q) {
      uint32_t ah[GT_GROUP][4], al[GT_GROUP][4];
#pragma unroll
      for (int j = 0; j < GT_GROUP; ++j) {
        const int p = (q * GT_GROUP + j) * 8;   // the k-step's first pixel
        const int ry = p / W, px = p - ry * W;
        const float* src = xs + (ry * SC + px) * GT_CS;
        const float v[4] = {src[0], src[8], src[4 * GT_CS],
                            src[4 * GT_CS + 8]};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tf32_split(__float_as_uint(v[i]), ah[j][i], al[j][i]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < GT_GROUP; ++j) {
        // 3xTF32: lo*hi + hi*lo + hi*hi, small terms first; the group's
        // first product starts the sum anew
        const uint32_t kb = gbase + (q * GT_GROUP + j) * 8 * N * 4;
        wgmma_tf32_rs<N>(acc, al[j], b_desc(kb), j != 0);
        wgmma_tf32_rs<N>(acc, ah[j], b_desc(kb + GT_PIXELS * N * 4), 1);
        wgmma_tf32_rs<N>(acc, ah[j], b_desc(kb), 1);
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < N / 2; ++i) tot[i] += acc[i];
    }
  }

  if (!live) return;
  float* out =
      a.part + ((size_t)blockIdx.x * M + (size_t)t * cin + ci + g) * a.cout;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int co = j * 8 + 2 * tig;
    if (co < a.cout) {
      *reinterpret_cast<float2*>(out + co) =
          make_float2(tot[4 * j], tot[4 * j + 1]);
      *reinterpret_cast<float2*>(out + 8 * a.cout + co) =
          make_float2(tot[4 * j + 2], tot[4 * j + 3]);
    }
  }
}

template <int N, bool F32>
static int wgrad_launch(const WgradWgArgs& a, int chunks, size_t smem,
                        cudaStream_t s) {
  void (*kernel)(WgradWgArgs);
  if constexpr (F32)
    kernel = conv_wgrad_tf32_kernel<N>;
  else
    kernel = conv_wgrad_wgmma_kernel<N>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(chunks,
                  a.cin / GW_CB * ((a.ntaps + GW_TG - 1) / GW_TG));
  kernel<<<grid, WG_CONSUMERS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// dx [N,H,W,cdx] (T) of the conv, from the f32 output gradient g
// [N,H,W,cg] and the weights transposed per tap ([taps][cg][cdx], T),
// over the ntaps mirrored (kh-1-dy, kw-1-dx) pairs of ``taps`` (host
// array), on the CUDA cores (FMA). Returns cudaGetLastError() after the
// launch (0 on success).
int masked_conv_dgrad(const void* g, const void* wt, void* dx,
                      const int* taps, int ntaps, int n_images, int H, int W,
                      int cg, int cdx, int kh, int kw, int tr, int bf16,
                      int threads, void* stream) {
  ConvArgs a;
  int e = conv_prepare(a, g, wt, dx, taps, ntaps, H, W, cg, cdx, kh, kw, tr);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? conv_launch(conv_fma_kernel<float, __nv_bfloat16,
                                            __nv_bfloat16>,
                            a, n_images, kw, threads, s)
              : conv_launch(conv_fma_kernel<float, float, float>, a,
                            n_images, kw, threads, s);
}

// The same on the tensor cores, dx bf16: g in bf16 (16-byte aligned), the
// transposed weights packed as conv_wgmma_kernel reads them with their
// columns zero-padded to npad, on tiles of ``tile_pixels`` (the port
// passes 128; 64 is measured, not routed); see wgmma_conv
// (masked_conv.cuh).
int masked_conv_dgrad_wgmma(const void* g, const void* wt, void* dx,
                            const int* taps, int ntaps, int n_images, int H,
                            int W, int cg, int cdx, int npad, int kh, int kw,
                            int tile_pixels, size_t limit, void* stream) {
  return wgmma_conv<__nv_bfloat16, false>(
      g, wt, dx, taps, ntaps, n_images, H, W, cg, cdx, npad, kh, kw, limit,
      tile_pixels, static_cast<cudaStream_t>(stream));
}

// The same in f32 by 3xTF32, dx f32: g f32 (16-byte aligned), the
// transposed f32 weights in the tf32 K-major order; cg % 16 == 0, npad at
// most 160; tiles as masked_conv_dgrad_wgmma's.
int masked_conv_dgrad_tf32(const void* g, const void* wt, void* dx,
                           const int* taps, int ntaps, int n_images, int H,
                           int W, int cg, int cdx, int npad, int kh, int kw,
                           int tile_pixels, size_t limit, void* stream) {
  return wgmma_conv<float, true>(g, wt, dx, taps, ntaps, n_images, H, W, cg,
                                 cdx, npad, kh, kw, limit, tile_pixels,
                                 static_cast<cudaStream_t>(stream));
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
  a.co_tiles = (cout + FW_CO - 1) / FW_CO;
  for (int t = 0; t < ntaps; ++t) {
    a.tap_dy[t] = c.tap_dy[t];
    a.tap_dx[t] = c.tap_dx[t];
  }
  const size_t smem = ((size_t)(a.dy_hi - a.dy_lo + 1) * (W + 2 * a.pw) *
                           FW_CI +
                       (size_t)W * FW_CO) *
                      sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? conv_wgrad_kernel<__nv_bfloat16>
                     : conv_wgrad_kernel<float>;
  cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid((a.rows + rows_per_chunk - 1) / rows_per_chunk,
                  (cin + FW_CI - 1) / FW_CI,
                  a.co_tiles * ((ntaps + TG - 1) / TG));
  kernel<<<grid, FW_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"

// The tensor-core wgrad GEMM (bf16, or with F32 by 3xTF32) into per-chunk
// partials; see masked_conv_wgrad_wgmma and masked_conv_wgrad_tf32.
template <bool F32>
static int wgrad_gemm(const void* x, const void* gp, void* part,
                      const int* taps, int ntaps, int n_images, int H, int W,
                      int cin, int cout, int npad, int kh, int kw,
                      int sub_per_chunk, cudaStream_t s) {
  const int tr = F32 ? gt_tile_rows(W) : wg_tile_rows(W);
  if (!tr || H % tr || cin % GW_CB || cout % 2 || cout > npad ||
      sub_per_chunk < 1 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(gp) % 16)
    return (int)cudaErrorInvalidValue;
  ConvArgs c;  // for its tap checks and row range
  int e = conv_prepare(c, x, gp, part, taps, ntaps, H, W, cin, cout, kh, kw,
                       tr);
  if (e) return e;
  WgradWgArgs a;
  a.x = x;
  a.gp = gp;
  a.part = static_cast<float*>(part);
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.ph = c.ph;
  a.pw = c.pw;
  a.ntaps = ntaps;
  a.dy_lo = c.dy_lo;
  a.dy_hi = c.dy_hi;
  a.tr = tr;
  a.n_sub = n_images * H / tr;
  a.sub_per_chunk = sub_per_chunk;
  for (int t = 0; t < ntaps; ++t) {
    a.tap_dy[t] = c.tap_dy[t];
    a.tap_dx[t] = c.tap_dx[t];
  }
  const int chunks = (a.n_sub + sub_per_chunk - 1) / sub_per_chunk;
  const int span = c.dy_hi - c.dy_lo;
  const size_t smem = 2 * (size_t)(F32 ? gt_stage_bytes(tr, W, kw, span, npad)
                                       : gw_stage_bytes(tr, W, kw, span, npad));
  switch (npad) {
    case 32: return wgrad_launch<32, F32>(a, chunks, smem, s);
    case 64: return wgrad_launch<64, F32>(a, chunks, smem, s);
    case 128: return wgrad_launch<128, F32>(a, chunks, smem, s);
    case 160: return wgrad_launch<160, F32>(a, chunks, smem, s);
    case 256:
      // f32 at N = 256 would need 256 accumulator registers a thread
      if constexpr (!F32) return wgrad_launch<256, false>(a, chunks, smem, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Dynamic shared memory of the tensor-core wgrad at this shape (two
// stages), or 0 where it does not tile it: W of 16, 32, 64 or 128 with
// H a multiple of the sub-tile's 128 / W rows, cin a multiple of GW_CB.
size_t masked_conv_wgrad_wgmma_smem(int H, int W, int cin, int kw, int span,
                                    int npad) {
  const int tr = wg_tile_rows(W);
  if (!tr || H % tr || cin % GW_CB) return 0;
  return 2 * (size_t)gw_stage_bytes(tr, W, kw, span, npad);
}

// Weight-gradient partials [chunks][ntaps][cin][cout] f32 on the tensor
// cores, chunks = ceil(N*H*W / 128 / sub_per_chunk): x [N,H,W,cin] bf16
// and G packed [N*H*W/16][npad/8][2][8][8] bf16 (both 16-byte aligned),
// cin % GW_CB == 0, cout even and <= npad, at the ntaps (dy, dx) pairs of
// ``taps``.
int masked_conv_wgrad_wgmma(const void* x, const void* gp, void* part,
                            const int* taps, int ntaps, int n_images, int H,
                            int W, int cin, int cout, int npad, int kh,
                            int kw, int sub_per_chunk, void* stream) {
  return wgrad_gemm<false>(x, gp, part, taps, ntaps, n_images, H, W, cin,
                           cout, npad, kh, kw, sub_per_chunk,
                           static_cast<cudaStream_t>(stream));
}

// The 3xTF32 wgrad's dynamic shared memory at this shape (two stages), or
// 0 where it does not tile it: W of 16, 32 or 64 with H a multiple of the
// 64-pixel sub-tile's 64 / W rows, cin a multiple of GW_CB.
size_t masked_conv_wgrad_tf32_smem(int H, int W, int cin, int kw, int span,
                                   int npad) {
  const int tr = gt_tile_rows(W);
  if (!tr || H % tr || cin % GW_CB) return 0;
  return 2 * (size_t)gt_stage_bytes(tr, W, kw, span, npad);
}

// The same partials in f32 by 3xTF32, chunks = ceil(N*H*W / 64 /
// sub_per_chunk): x [N,H,W,cin] f32 and G packed [N*H*W/8][npad/8][2][8][4]
// f32 (the tf32 K-major layout with the NHWC pixels as K), npad at most
// 160. K1's f32 backward can run its wgrad on this entry as its bf16
// backward runs on masked_conv_wgrad_wgmma.
int masked_conv_wgrad_tf32(const void* x, const void* gp, void* part,
                           const int* taps, int ntaps, int n_images, int H,
                           int W, int cin, int cout, int npad, int kh, int kw,
                           int sub_per_chunk, void* stream) {
  return wgrad_gemm<true>(x, gp, part, taps, ntaps, n_images, H, W, cin,
                          cout, npad, kh, kw, sub_per_chunk,
                          static_cast<cudaStream_t>(stream));
}

// The partials' sum, in chunk order, into dW [kh][kw][cin][cout] (T):
// ``slot`` (device, kk = kh * kw ints) names the live tap of each kernel
// position, -1 for the dead ones (zeros).
int masked_conv_wreduce(const void* part, void* dw, const void* slot,
                        int ntaps, int chunks, int cin, int cout, int kk,
                        int bf16, void* stream) {
  if (ntaps < 1 || kk < ntaps || kk > MAX_TAPS || chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int per_tap = cin * cout;
  const dim3 grid((per_tap + RD_THREADS * RD_ITEMS - 1) /
                      (RD_THREADS * RD_ITEMS),
                  kk);
  const float* p = static_cast<const float*>(part);
  const int* sl = static_cast<const int*>(slot);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    conv_wreduce_kernel<<<grid, RD_THREADS, 0, s>>>(
        p, static_cast<__nv_bfloat16*>(dw), sl, chunks, ntaps, per_tap);
  else
    conv_wreduce_kernel<<<grid, RD_THREADS, 0, s>>>(
        p, static_cast<float*>(dw), sl, chunks, ntaps, per_tap);
  return (int)cudaGetLastError();
}

}  // extern "C"
