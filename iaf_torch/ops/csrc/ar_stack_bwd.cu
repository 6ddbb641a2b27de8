// K1 backward: dgrad and wgrad of the masked AR conv chain of one IAF step.
//
// Replaces the backward of iaf_tpu/ops/ar_stack.py (_bwd, :251-262), which
// re-ran the XLA twin's forward and took its VJP. Here the forward kernel
// (ar_stack.cu) has already written each hidden conv's f32 pre-activation
// a_i (2 x [N,H,W,ch] per IAF step, 5.2 MB at batch 32: cheaper to keep
// than to recompute the chain), and the wrapper walks the convs from the
// head down. For conv c with input X (z, or T(ELU(a_{c-1}))), weights W
// over the 5 live taps and output gradient G = dL/d(conv output):
//
//   dgrad  dX[y,x,ci] = sum_t sum_co G[y+1-dy, x+1-dx, co] W[t][ci][co]
//          then times ELU'(a_{c-1}) = (a > 0 ? 1 : exp(a)) for a hidden
//          input, giving the next conv's G; for conv 0 it is dz.
//   wgrad  dW[t][ci][co] = sum over N*H*W of X[y+dy-1, x+dx-1, ci] G[y,x,co]
//          and db[co] = sum G[., co].
//
// Bound on the H100 per call at batch 32, paper widths (cz=32, ch=160,
// cout=64): 2 x 3.36 GFLOP over the live taps (dgrad and wgrad), 6.7 us at
// the bf16 tensor-core rate (989 TFLOP/s), against ~20 MB of compulsory
// traffic (~6 us at 3.35 TB/s): bound by operations, just. In f32 the
// same products take 13.6 us at one TF32 product per f32 product (495
// TFLOP/s, the card's peak for f32 operands), 40.7 us at the three of
// 3xTF32 and 100 us on the FP32 CUDA cores (67 TFLOP/s).
//
// Design, on the tensor cores (ar_stack.py _dgrad_wgmma, _wgrad_wgmma):
// both products run on K2's kernels (masked_conv.cuh, masked_conv_bwd.cu)
// through their C entries, which take any list of live taps: the 3x3
// raster mask is 5 of them. bf16 runs K2's bf16 wgmma kernels; f32 (the
// f32 recipe) K2's 3xTF32 ones, each f32 product lo*hi + hi*lo + hi*hi
// of tf32 parts split on chip, so it holds the f64 twin at ~1e-6 of max
// where one TF32 product per f32 product misses 1e-5.
// * dgrad is conv_wgmma_kernel<N, bf16> on G in bf16, or
//   conv_tf32_kernel<N> on G in f32, over the mirrored taps, the weights
//   transposed per tap and packed for every conv in one launch
//   (ar_pack_wt_kernel<T>, from the weights' own strides: the model hands
//   K1 permuted views; in f32 in the tf32 K-major order, 4 K values a
//   16-byte row). dX comes out in T: bf16 where the twin's autograd
//   rounds it (the bf16 conv's input gradient), f32 as it is.
// * The glue between convs is one pass per hidden conv here,
//   ar_glue_kernel<T>: from dX (T) and a_{c-1} (f32) it writes the next G
//   = f32(dX) * ELU'(a) in T NHWC (the next dgrad's input), in wgrad's
//   packed B order (the next wgrad's operand: bf16 8 pixels a 16-byte
//   row, f32 4), in f32 where dcontext needs it (c = 1; in f32 the NHWC G
//   itself), the per-block sums of G for db, and X_c = T(ELU(a_{c-1})),
//   this conv's wgrad input, bit for bit what the forward fed it (elu()
//   is the forward's own, common.cuh). The head's G (f32, from K3's and
//   K4's backward) goes through the same kernel without the ELU: cast
//   (bf16), pack and db sums in one launch; in f32 it is the first
//   dgrad's input as it is.
// * wgrad is conv_wgrad_wgmma_kernel (bf16, 128-pixel sub-tiles) or
//   conv_wgrad_tf32_kernel (f32, 64-pixel sub-tiles, G's slice split on
//   chip), a GEMM over the pixels (A gathered from X's staged rows, B the
//   packed G) writing per-chunk f32 partials.
// * ar_wreduce_kernel sums the partials in chunk order into dW (zeros at
//   the 4 dead taps) and the glue's per-block db sums in block order into
//   db (a warp per channel, lanes over blocks, then a fixed shuffle tree).
// No atomics anywhere, so the same inputs give the same bits. 13
// launches per call of 3 convs: the weight pack, the head pass, then per
// conv dgrad, glue (hidden convs), wgrad and reduce.
//
// The shapes those kernels do not tile (widths or heights that are not
// whole tiles, channels not in whole blocks) stay on FP32 FMA, on the CUDA cores (bf16
// operands widened on load):
// * ar_dgrad_kernel gives each block one image row and stages the two
//   gradient rows it reads (the transpose of a row-causal conv is
//   anti-causal: rows y and y+1, taps mirrored), one thread per input
//   channel and PX pixels, weights packed [5][cout][cin], with ELU'
//   fused into its output;
// * ar_wgrad_kernel: each block owns a chunk of image rows and a 32 x 32
//   (ci x co) tile of all 5 taps in registers (db folded in), written as
//   a partial; the same ar_wreduce_kernel sums them in chunk order.
//
// Types: T = float or __nv_bfloat16 for z, the weights and dz/dW; the
// pre-activations, db and the FMA path's gradients between convs are f32.

#include <type_traits>

#include "common.cuh"

#define NTAPS 5
#define PX 8        // dgrad: input pixels per thread item
#define WG_CI 32    // wgrad: input channels per block (8 warps x 4)
#define WG_CO 32    // wgrad: output channels per block (one per lane)
#define WG_THREADS 256

struct DgradArgs {
  const float* g;     // [N,H,W,cout] f32 gradient of the conv's output
  const void* wt;     // [NTAPS, cout, cin] T
  const float* pre;   // [N,H,W,cin] f32 pre-activation of the input, or null
  void* out;          // f32 [N,H,W,cin] if pre, else T (dz)
  int H, W, cin, cout;
};

__host__ __device__ static inline int dgrad_ring_width(int W) {
  return W + 2 + PX;
}

template <typename T>
__global__ void ar_dgrad_kernel(DgradArgs a) {
  extern __shared__ __align__(16) float gsm[];  // [2][RW][cout]
  const int H = a.H, W = a.W, RW = dgrad_ring_width(W);
  const int n = blockIdx.x / H, y = blockIdx.x - n * H;
  const int cin = a.cin, cout = a.cout;
  // slot 0: gradient row y, slot 1: row y+1; padded column x+1 holds
  // pixel x, zero outside the image
  for (int i = threadIdx.x; i < 2 * RW * cout; i += blockDim.x) {
    const int slot = i / (RW * cout), rem = i - slot * RW * cout;
    const int col = rem / cout, co = rem - col * cout;
    const int yy = y + slot, x = col - 1;
    float v = 0.f;
    if (yy < H && x >= 0 && x < W)
      v = a.g[(((size_t)n * H + yy) * W + x) * cout + co];
    gsm[i] = v;
  }
  __syncthreads();

  const T* __restrict__ wt = static_cast<const T*>(a.wt);
  const int ngroups = (W + PX - 1) / PX;
  for (int item = threadIdx.x; item < cin * ngroups; item += blockDim.x) {
    const int ci = item % cin;
    const int x0 = (item / cin) * PX;
    float acc[PX];
#pragma unroll
    for (int q = 0; q < PX; ++q) acc[q] = 0.f;
#pragma unroll
    for (int t = 0; t < NTAPS; ++t) {
      // live taps (0,0) (0,1) (0,2) (1,0) (1,1): dy = 0 reads the
      // gradient row below (slot 1), dy = 1 the same row (slot 0); input
      // pixel x reads output pixel x+1-dx, at padded column x+2-dx
      const int slot = t < 3 ? 1 : 0;
      const int dx = t < 3 ? t : t - 3;
      const float* grow = gsm + ((size_t)slot * RW + x0 + 2 - dx) * cout;
      const T* wcol = wt + (size_t)t * cout * cin + ci;
      for (int co = 0; co < cout; ++co) {
        const float wv = to_f(wcol[(size_t)co * cin]);
#pragma unroll
        for (int q = 0; q < PX; ++q)
          acc[q] = fmaf(grow[q * cout + co], wv, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < PX; ++q) {
      const int x = x0 + q;
      if (x >= W) break;
      const size_t idx = (((size_t)n * H + y) * W + x) * cin + ci;
      if (a.pre != nullptr) {
        const float pv = a.pre[idx];
        static_cast<float*>(a.out)[idx] =
            acc[q] * (pv > 0.f ? 1.f : __expf(pv));
      } else {
        static_cast<T*>(a.out)[idx] = from_f<T>(acc[q]);
      }
    }
  }
}

struct WgradArgs {
  const void* x;      // [N,H,W,cin] T conv input (conv 0), or null
  const float* pre;   // [N,H,W,cin] f32: input is T(ELU(pre)), or null
  const float* g;     // [N,H,W,cout] f32 gradient of the conv's output
  float* part;        // [chunks][NTAPS*cin*cout + cout] f32 partials
  int H, W, cin, cout, rows, rows_per_chunk;
};

template <typename T>
__global__ void __launch_bounds__(WG_THREADS)
    ar_wgrad_kernel(WgradArgs a) {
  extern __shared__ __align__(16) float wsm[];
  const int H = a.H, W = a.W, XW = W + 2;
  float* xs = wsm;                        // [2][XW][WG_CI] rows y-1, y
  float* gs = wsm + 2 * XW * WG_CI;       // [W][WG_CO] gradient row y
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ci0 = blockIdx.y * WG_CI, co0 = blockIdx.z * WG_CO;
  const int r0 = blockIdx.x * a.rows_per_chunk;
  const int r1 = min(r0 + a.rows_per_chunk, a.rows);
  float acc[NTAPS][4];
#pragma unroll
  for (int t = 0; t < NTAPS; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;
  float bacc = 0.f;

  for (int r = r0; r < r1; ++r) {
    const int n = r / H, y = r - n * H;
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * XW * WG_CI; i += blockDim.x) {
      const int slot = i / (XW * WG_CI), rem = i - slot * XW * WG_CI;
      const int col = rem / WG_CI, c = rem - col * WG_CI;
      const int yy = y - 1 + slot, x = col - 1, ci = ci0 + c;
      float v = 0.f;
      if (yy >= 0 && x >= 0 && x < W && ci < a.cin) {
        const size_t idx = (((size_t)n * H + yy) * W + x) * a.cin + ci;
        if (a.pre != nullptr)
          v = to_f(from_f<T>(elu(a.pre[idx])));
        else
          v = to_f(static_cast<const T*>(a.x)[idx]);
      }
      xs[i] = v;
    }
    for (int i = threadIdx.x; i < W * WG_CO; i += blockDim.x) {
      const int x = i / WG_CO, c = i - x * WG_CO, co = co0 + c;
      gs[i] = co < a.cout
                  ? a.g[(((size_t)n * H + y) * W + x) * a.cout + co]
                  : 0.f;
    }
    __syncthreads();
    for (int x = 0; x < W; ++x) {
      const float gv = gs[x * WG_CO + lane];
      bacc += gv;
#pragma unroll
      for (int t = 0; t < NTAPS; ++t) {
        // tap (dy, dx) reads input row y+dy-1 (slot dy), pixel x+dx-1 at
        // padded column x+dx
        const int slot = t < 3 ? 0 : 1;
        const int dx = t < 3 ? t : t - 3;
        const float4 xv = *reinterpret_cast<const float4*>(
            xs + (slot * XW + x + dx) * WG_CI + 4 * warp);
        acc[t][0] = fmaf(xv.x, gv, acc[t][0]);
        acc[t][1] = fmaf(xv.y, gv, acc[t][1]);
        acc[t][2] = fmaf(xv.z, gv, acc[t][2]);
        acc[t][3] = fmaf(xv.w, gv, acc[t][3]);
      }
    }
  }

  const size_t M = (size_t)NTAPS * a.cin * a.cout + a.cout;
  float* base = a.part + (size_t)blockIdx.x * M;
  const int co = co0 + lane;
  if (co >= a.cout) return;
#pragma unroll
  for (int t = 0; t < NTAPS; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + 4 * warp + j;
      if (ci < a.cin) base[((size_t)t * a.cin + ci) * a.cout + co] = acc[t][j];
    }
  if (blockIdx.y == 0 && warp == 0)
    base[(size_t)NTAPS * a.cin * a.cout + co] = bacc;
}

#define RD_THREADS 256

// Sums the weight partials (chunks x [NTAPS*cin*cout], ``pstride`` apart)
// in chunk order into dW ([3,3,cin,cout] T: the live taps are its first 5
// (dy, dx) positions in raster order, the dead 4 get zeros), and the bias
// partials (dbchunks x [cout], ``dbstride`` apart) into db ([cout] f32).
// The first ``dw_blocks`` blocks cover dW, one output a thread (coalesced;
// the chunk loop unrolled, so 4 loads are in flight a thread, and enough
// blocks to spread over the SMs: 180 at 32->160); the rest give each db
// channel one warp: lane l sums partials l, l + 32, ... in order (8 loads
// in flight), then a fixed shuffle tree adds the lanes.
template <typename T>
__global__ void __launch_bounds__(RD_THREADS)
    ar_wreduce_kernel(const float* __restrict__ part, size_t pstride,
                      int chunks, const float* __restrict__ dbpart,
                      size_t dbstride, int dbchunks, T* __restrict__ dw,
                      float* __restrict__ db, int cin, int cout,
                      int dw_blocks) {
  const size_t live = (size_t)NTAPS * cin * cout;
  const size_t full = (size_t)9 * cin * cout;
  if ((int)blockIdx.x < dw_blocks) {
    const size_t i = (size_t)blockIdx.x * RD_THREADS + threadIdx.x;
    float s = 0.f;
    if (i < live) {
      const float* p = part + i;
#pragma unroll 4
      for (int k = 0; k < chunks; ++k) s += p[k * pstride];
    }
    if (i < full) dw[i] = from_f<T>(s);
    return;
  }
  const int co = (blockIdx.x - dw_blocks) * (RD_THREADS / 32) +
                 (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (co >= cout) return;
  float s = 0.f;
#pragma unroll 8
  for (int k = lane; k < dbchunks; k += 32) s += dbpart[k * dbstride + co];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) db[co] = s;
}

#define GL_THREADS 512   // glue: threads per block, at most

struct GlueArgs {
  const void* src;     // [P][C] the head's G (f32) or dgrad's dX (T)
  const float* pre;    // [P][C] f32 pre-activation a (hidden), or null
  void* gt;            // [P][C] T G: the next dgrad's input, or null
  void* gp;            // G packed in wgmma_pack order, T
  float* g32;          // [P][C] f32 G (dcontext), or null
  void* x;             // [P][C] T ELU(a): this conv's wgrad input
  float* dbpart;       // [gridDim.x][C] f32 sums of G per block
  int P, C, npad, groups_per_block;
};

// One thread per channel (threadIdx.x < npad; those past C write the
// packed G's zero columns) and group of 8 consecutive pixels (threadIdx.y
// strides over the block's groups; the wrapper gives each thread one).
// The packed G is wgmma_pack's layout with the pixels as K, E = 16 /
// sizeof(T) pixels of one column a 16-byte row: element [s][j][h][n][k] =
// G[2E s + E h + k][8 j + n]. In bf16 (E = 8) group q is half q & 1 of
// k-step q / 2, one store; in f32 (E = 4, the 3xTF32 wgrad's tf32 order)
// it is both halves of k-step q, two stores. G (and the block's db sum)
// follows the twin's autograd: f32(dX) times ELU'(a) in f32, rounded to
// T where the next products read it (bf16), or kept (f32).
template <typename T, bool kHidden>
__global__ void __launch_bounds__(GL_THREADS) ar_glue_kernel(GlueArgs a) {
  constexpr int E = 16 / sizeof(T);
  using Tin = std::conditional_t<kHidden, T, float>;
  __shared__ float red[GL_THREADS];
  const int co = threadIdx.x, C = a.C;
  const bool live = co < C;
  const int j = co >> 3, n = co & 7;
  const int q0 = blockIdx.x * a.groups_per_block;
  const int q1 = min(q0 + a.groups_per_block, a.P / 8);
  const Tin* __restrict__ src = static_cast<const Tin*>(a.src);
  T* gt = static_cast<T*>(a.gt);
  T* x = static_cast<T*>(a.x);
  T* gp = static_cast<T*>(a.gp);
  float db = 0.f;
  for (int q = q0 + threadIdx.y; q < q1; q += blockDim.y) {
    uint32_t words[2 * sizeof(T)] = {};   // the group's 8 values, as T
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (!live) continue;
      const size_t idx = ((size_t)q * 8 + k) * C + co;
      float v = to_f(src[idx]);
      if constexpr (kHidden) {
        const float p = a.pre[idx];
        v = p > 0.f ? v : v * expf(p);
        x[idx] = from_f<T>(elu(p));
      }
      const T vt = from_f<T>(v);
      if (gt != nullptr) gt[idx] = vt;
      if (a.g32 != nullptr) a.g32[idx] = v;
      db += v;
      if constexpr (E == 8)
        words[k >> 1] |= (uint32_t)__bfloat16_as_ushort(vt) << (16 * (k & 1));
      else
        words[k] = __float_as_uint(v);
    }
#pragma unroll
    for (int u = 0; u < 8 / E; ++u) {
      const int p0 = 8 * q + E * u;   // the row's first pixel
      const int s = p0 / (2 * E), h = (p0 / E) & 1;
      *reinterpret_cast<uint4*>(
          gp + ((((size_t)s * (a.npad / 8) + j) * 2 + h) * 8 + n) * E) =
          make_uint4(words[4 * u], words[4 * u + 1], words[4 * u + 2],
                     words[4 * u + 3]);
    }
  }
  red[threadIdx.y * blockDim.x + co] = db;
  __syncthreads();
  if (threadIdx.y == 0 && live) {
    float s = 0.f;
    for (int y = 0; y < (int)blockDim.y; ++y) s += red[y * blockDim.x + co];
    a.dbpart[(size_t)blockIdx.x * C + co] = s;
  }
}

#define MAX_PACK 32        // convs per pack launch (ar_stack.cu MAX_CONVS)
#define PK_THREADS 256

struct PackArgs {
  const void* w[MAX_PACK];           // [3][3][cin][cout] T, any strides
  long long st[MAX_PACK][4];         // its strides in elements
  uint4* out[MAX_PACK];    // [5][cout/2E][npad/8][2][8][E] T
  int cin[MAX_PACK], cout[MAX_PACK], npad[MAX_PACK];
  int start[MAX_PACK + 1];           // each conv's first item
  int n;
};

// dgrad's weights of every conv in one launch: conv c's 5 live taps
// ((dy, dx) = (t / 3, t % 3), the first 5 in raster order) transposed per
// tap in wgmma_pack order with K = cout and N = cin padded to npad, E =
// 16 / sizeof(T) K values a 16-byte row (8 in bf16; 4 in f32, the 3xTF32
// dgrad's tf32 order): element [t][s][j][h][n][k] = W[t][8 j + n][2E s +
// E h + k], zero for 8 j + n >= cin. One item is one (t, s, j, h, n): E
// loads of the strided weights (the model's are permuted views), one
// 16-byte store.
template <typename T>
__global__ void __launch_bounds__(PK_THREADS) ar_pack_wt_kernel(PackArgs a) {
  constexpr int E = 16 / sizeof(T);
  const int i = blockIdx.x * PK_THREADS + threadIdx.x;
  if (i >= a.start[a.n]) return;
  int c = 0;
  while (i >= a.start[c + 1]) ++c;
  const int item = i - a.start[c];
  const int cin = a.cin[c], cout = a.cout[c], jn = a.npad[c] / 8;
  int r = item;
  const int n = r & 7;
  r >>= 3;
  const int h = r & 1;
  r >>= 1;
  const int j = r % jn;
  r /= jn;
  const int s = r % (cout / (2 * E)), t = r / (cout / (2 * E));
  const int ci = 8 * j + n;
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (ci < cin) {
    const long long* st = a.st[c];
    const T* src = static_cast<const T*>(a.w[c]) + (t / 3) * st[0] +
                   (t % 3) * st[1] + ci * st[2] + (2 * E * s + E * h) * st[3];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if constexpr (E == 8)
        v[k >> 1] |= (uint32_t)__bfloat16_as_ushort(src[k * st[3]])
                     << (16 * (k & 1));
      else
        v[k] = __float_as_uint(src[k * st[3]]);
    }
  }
  a.out[c][item] = make_uint4(v[0], v[1], v[2], v[3]);
}

template <typename T>
static int launch_dgrad(const DgradArgs& a, int n_images,
                        cudaStream_t stream) {
  const size_t smem =
      (size_t)2 * dgrad_ring_width(a.W) * a.cout * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ar_dgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int items = a.cin * ((a.W + PX - 1) / PX);
  int threads = 32 * ((items + 31) / 32);
  if (threads > 1024) threads = 1024;
  ar_dgrad_kernel<T><<<n_images * a.H, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_wgrad(const WgradArgs& a, cudaStream_t stream) {
  const size_t smem =
      ((size_t)2 * (a.W + 2) * WG_CI + (size_t)a.W * WG_CO) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ar_wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.rows + a.rows_per_chunk - 1) / a.rows_per_chunk,
                  (a.cin + WG_CI - 1) / WG_CI, (a.cout + WG_CO - 1) / WG_CO);
  ar_wgrad_kernel<T><<<grid, WG_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// Input gradient of one conv: f32 gradient of the previous conv's output
// (times ELU' of ``pre``) when ``pre`` is given, else dz in T. Returns
// cudaGetLastError() after the launch (0 on success).
int ar_stack_dgrad(const void* g, const void* wt, const void* pre, void* out,
                   int n_images, int H, int W, int cin, int cout, int bf16,
                   void* stream) {
  DgradArgs a;
  a.g = static_cast<const float*>(g);
  a.wt = wt;
  a.pre = static_cast<const float*>(pre);
  a.out = out;
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dgrad<__nv_bfloat16>(a, n_images, s)
              : launch_dgrad<float>(a, n_images, s);
}

// Per-chunk weight and bias gradient partials of one conv, chunks of
// ``rows_per_chunk`` image rows; the input is ``x`` (T) or T(ELU(pre)).
int ar_stack_wgrad(const void* x, const void* pre, const void* g, void* part,
                   int n_images, int H, int W, int cin, int cout,
                   int rows_per_chunk, int bf16, void* stream) {
  if ((x == nullptr) == (pre == nullptr) || rows_per_chunk < 1)
    return (int)cudaErrorInvalidValue;
  WgradArgs a;
  a.x = x;
  a.pre = static_cast<const float*>(pre);
  a.g = static_cast<const float*>(g);
  a.part = static_cast<float*>(part);
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.rows = n_images * H;
  a.rows_per_chunk = rows_per_chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_wgrad<__nv_bfloat16>(a, s)
              : launch_wgrad<float>(a, s);
}

// The sum of the weight partials (chunks x [5*cin*cout] f32, ``pstride``
// apart) in chunk order into dW (all 9 taps, T) and of the bias partials
// (dbchunks x [cout] f32, ``dbstride`` apart) in order into db (f32).
int ar_stack_wreduce(const void* part, long long pstride, int chunks,
                     const void* dbpart, long long dbstride, int dbchunks,
                     void* dw, void* db, int cin, int cout, int bf16,
                     void* stream) {
  if (chunks < 1 || dbchunks < 1) return (int)cudaErrorInvalidValue;
  const size_t full = (size_t)9 * cin * cout;
  const int dw_blocks = (int)((full + RD_THREADS - 1) / RD_THREADS);
  const int db_blocks = (cout + RD_THREADS / 32 - 1) / (RD_THREADS / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(part);
  const float* dp = static_cast<const float*>(dbpart);
  float* b = static_cast<float*>(db);
  if (bf16)
    ar_wreduce_kernel<__nv_bfloat16><<<dw_blocks + db_blocks, RD_THREADS, 0,
                                       s>>>(
        p, (size_t)pstride, chunks, dp, (size_t)dbstride, dbchunks,
        static_cast<__nv_bfloat16*>(dw), b, cin, cout, dw_blocks);
  else
    ar_wreduce_kernel<float><<<dw_blocks + db_blocks, RD_THREADS, 0, s>>>(
        p, (size_t)pstride, chunks, dp, (size_t)dbstride, dbchunks,
        static_cast<float*>(dw), b, cin, cout, dw_blocks);
  return (int)cudaGetLastError();
}

// dgrad's packed weights of ``n`` convs in one launch, bf16 or with
// ``f32`` f32 (E = 8 or 4 K values a 16-byte row): ``w`` and ``out`` host
// arrays of device pointers (``out`` 16-byte aligned), ``dims`` n triples
// (cin, cout, npad) with cout % 2E == 0, npad % 8 == 0 and cin <= npad,
// ``strides`` n quadruples (each weight's [3][3][cin][cout] strides in
// elements).
int ar_stack_pack_wt(void* const* w, void* const* out, const int* dims,
                     const long long* strides, int n, int f32,
                     void* stream) {
  if (n < 1 || n > MAX_PACK) return (int)cudaErrorInvalidValue;
  const int e = f32 ? 4 : 8;
  PackArgs a;
  a.n = n;
  a.start[0] = 0;
  for (int c = 0; c < n; ++c) {
    const int cin = dims[3 * c], cout = dims[3 * c + 1],
              npad = dims[3 * c + 2];
    if (cout % (2 * e) || npad % 8 || cin > npad ||
        reinterpret_cast<uintptr_t>(out[c]) % 16)
      return (int)cudaErrorInvalidValue;
    a.w[c] = w[c];
    for (int d = 0; d < 4; ++d) a.st[c][d] = strides[4 * c + d];
    a.out[c] = static_cast<uint4*>(out[c]);
    a.cin[c] = cin;
    a.cout[c] = cout;
    a.npad[c] = npad;
    a.start[c + 1] = a.start[c] + 5 * (cout / e) * npad;
  }
  const int blocks = (a.start[n] + PK_THREADS - 1) / PK_THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    ar_pack_wt_kernel<float><<<blocks, PK_THREADS, 0, s>>>(a);
  else
    ar_pack_wt_kernel<__nv_bfloat16><<<blocks, PK_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The glue pass over P pixels of C channels in T = bf16, or with ``f32``
// f32 (P % 2E == 0, C <= npad <= 256, npad % 8 == 0, gp 16-byte
// aligned): with ``pre`` (hidden conv) src is dgrad's dX (T), G = f32(dX)
// * ELU'(pre) and x = T(ELU(pre)) is written; without it src is the
// head's f32 G and x is not written. Writes gt (T G, if not null), gp,
// g32 (if not null) and one row of db sums per block, blocks of
// ``groups_per_block`` groups of 8 pixels: ceil(P / 8 / groups_per_block)
// rows.
int ar_stack_glue(const void* src, const void* pre, void* gt, void* gp,
                  void* g32, void* x, void* dbpart, int P, int C, int npad,
                  int groups_per_block, int f32, void* stream) {
  if (P % (f32 ? 8 : 16) || C < 1 || C > npad || npad % 8 || npad > 256 ||
      groups_per_block < 1 || (pre == nullptr) != (x == nullptr) ||
      reinterpret_cast<uintptr_t>(gp) % 16)
    return (int)cudaErrorInvalidValue;
  GlueArgs a;
  a.src = src;
  a.pre = static_cast<const float*>(pre);
  a.gt = gt;
  a.gp = gp;
  a.g32 = static_cast<float*>(g32);
  a.x = x;
  a.dbpart = static_cast<float*>(dbpart);
  a.P = P;
  a.C = C;
  a.npad = npad;
  a.groups_per_block = groups_per_block;
  const dim3 block(npad, GL_THREADS / npad);
  const int groups = P / 8;
  const int blocks = (groups + groups_per_block - 1) / groups_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32 && pre != nullptr)
    ar_glue_kernel<float, true><<<blocks, block, 0, s>>>(a);
  else if (f32)
    ar_glue_kernel<float, false><<<blocks, block, 0, s>>>(a);
  else if (pre != nullptr)
    ar_glue_kernel<__nv_bfloat16, true><<<blocks, block, 0, s>>>(a);
  else
    ar_glue_kernel<__nv_bfloat16, false><<<blocks, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
