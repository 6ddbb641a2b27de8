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
// The forward is causal in rows (output row y reads rows y-1, y), so its
// transpose is anti-causal: input row y reads output-gradient rows y and
// y+1 with the tap offsets mirrored. dgrad gives each block one image row
// and stages those two gradient rows (zero past the last row and at the
// column halo) in shared memory, then runs the forward FMA path's scheme
// with the roles of cin and cout swapped: one thread per input channel and
// PX neighbouring pixels, gradients broadcast from shared memory, weights
// (packed [5][cout][cin]) coalesced across input channels.
//
// wgrad is a reduction over N*H*W pixels (8192 at batch 32). Blocks run in
// no order, so it is made deterministic: each block owns a chunk of image
// rows and a 32 x 32 (ci x co) tile of all 5 taps, keeps its sums in
// registers (a warp's lanes are 32 output channels, each holding 4 input
// channels x 5 taps), writes them as a partial, and a second kernel adds
// the partials in chunk order. The same launch gives the same bits.
//
// Bound on the H100 per IAF step at batch 32, paper widths (cz=32,
// ch=160, cout=64): 2 x 3.36 GFLOP over the live taps (dgrad and wgrad) at
// the f32 FMA rate (67 TFLOP/s) is ~0.1 ms, or ~7 us at the bf16
// tensor-core rate, against ~26 MB of compulsory traffic (~8 us). This
// first version computes both on the CUDA cores in f32 (bf16 operands are
// widened on load), so its floor is the FMA rate; tensor cores are the
// next step.
//
// Types: T = float or __nv_bfloat16 for z, the weights and dz/dW; the
// gradients between convs, the pre-activations and db are f32.

// elu() is the forward's own (common.cuh), so the recomputed conv input is
// bit for bit the one the forward fed to the next conv.
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

// Sums the partials in chunk order into dW ([3,3,cin,cout] T: the live
// taps are its first 5 (dy, dx) positions in raster order, the dead 4 get
// zeros) and db ([cout] f32).
template <typename T>
__global__ void ar_wreduce_kernel(const float* part, T* dw, float* db,
                                  int chunks, int cin, int cout) {
  const size_t live = (size_t)NTAPS * cin * cout;
  const size_t full = (size_t)9 * cin * cout;
  const size_t M = live + cout;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= full + cout) return;
  if (i >= live && i < full) {
    dw[i] = from_f<T>(0.f);
    return;
  }
  const size_t j = i < live ? i : live + (i - full);
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += part[(size_t)k * M + j];
  if (i < live)
    dw[i] = from_f<T>(s);
  else
    db[i - full] = s;
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

// The partials' sum, in chunk order, into dW (all 9 taps) and db.
int ar_stack_wreduce(const void* part, void* dw, void* db, int chunks,
                     int cin, int cout, int bf16, void* stream) {
  const size_t total = (size_t)9 * cin * cout + cout;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(part);
  float* b = static_cast<float*>(db);
  if (bf16)
    ar_wreduce_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        p, static_cast<__nv_bfloat16*>(dw), b, chunks, cin, cout);
  else
    ar_wreduce_kernel<float><<<blocks, threads, 0, s>>>(
        p, static_cast<float*>(dw), b, chunks, cin, cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
