// K4: the discretized-logistic log-likelihood, for Hopper (forward and
// backward).
//
// Replaces iaf_tpu/ops/fused.py:_dl_kernel (:103, pallas_call at :121) and
// its backward _dl_bwd (:148, the VJP of the XLA twin): per example row,
// the sum over H*W*C of log(sigmoid(x + b/s) - sigmoid(x) + 1e-7) with
// x = (floor(sample / b) * b - mean) / s, s = exp(logscale) for a scalar
// logscale and b the bin size (1/256). The TPU kernel took one image per
// grid step into VMEM and summed it there; the backward gives dmean (the
// shape of mean) and one dlogscale summed over every element of every row.
//
// Bound on the H100: at the eval shape (2 x [1024, 3072] f32 in, [1024]
// out) the bytes take 7.5 us at 3.35 TB/s, and the arithmetic (some 70 FP32
// instructions and six SFU operations an element: three correctly rounded
// divisions, two exp, one log) about as long, so each has to run while the
// other's loads are in flight. At batch 32 (the training step) the 0.8 MB
// (backward 1.2 MB) are less than one launch takes.
//
// Design: a row is split over a thread-block cluster of S = 1, 2, 4 or 8
// blocks of 256 threads (the grid is S * rows blocks, cluster (S, 1, 1); S
// from the wrapper's dl_plan: at least two elements a thread, and no more
// splits once the card has two blocks an SM: 1 at N = 1024, 4 at batch
// 32). Each block reads its share of the row as float4 (scalar loads where
// the row or a pointer is not 16-byte aligned), a round's loads (two
// float4 of each input a thread) all issued before its arithmetic, keeps a
// running sum per
// thread, and reduces it by a warp-shuffle tree and then its warps in
// order; block 0 of the cluster adds the blocks' sums in rank order through
// distributed shared memory. Every sum is taken in a fixed order, so two
// calls give the same bits. The backward writes dmean as float4 and the
// row's share of dlogscale to part[row]; then each row takes a ticket (a
// fence and an atomicAdd on an int32 counter), and the last row to finish
// sums part[0..rows) in index order, writes dlogscale and sets the counter
// back to 0: one launch, no reduction after it, and a result that does
// not depend on which row finished last. The counter is scratch that the
// wrapper allocates once per device; the kernels allocate nothing.
//
// Arithmetic: the twin's (iaf_torch/distributions.py discretized_logistic
// and autograd of it), operation for operation, with correctly rounded
// divisions and no FMA contraction (__fdiv_rn, __fmul_rn, __fadd_rn,
// __fsub_rn; the flags are shared with the other sources, so contraction is
// forbidden per operation), full-precision expf and logf: sigmoid(x + b/s)
// - sigmoid(x) cancels (b/s = 1/256 at logscale 0), so an ulp of difference
// in x or a sigmoid comes out some 250 times larger, and a sample on a bin
// edge must snap to that bin. Shortcuts that keep the twin's values: 1 / y
// by __frcp_rn (the value of __fdiv_rn(1, y)); where the host finds b a
// power of two (pow2), sample * (1/b) for sample / b (both exact
// scalings, the same float for every sample); and the divisions by the
// scale through its reciprocal (div_scale). The arithmetic, not the bytes,
// is what bounds the kernel at N = 1024: with every load an L2 hit it
// takes as long as with its own loads, and with the arithmetic left out
// half as long (tools/k4_probe.py); __fdiv_rn's ten instructions and
// branch were the largest share that could go without changing a bit.
//
// Entry points (plain C, loaded with ctypes): dl_fwd, dl_bwd, and
// dl_launch_floor (an empty kernel on the same grid, the launch floor that
// measurements set beside the backward's bound).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int DL_THREADS = 256;   // threads a block (fused.py _DL_THREADS)
constexpr int DL_WARPS = DL_THREADS / 32;
constexpr int DL_VEC = 2;         // float4 of each input a thread loads a round

struct DlConsts {
  float binsize, inv_bin, scale, rscale, step;
  bool mark;   // divide by the scale through its reciprocal (div_scale)
};

__device__ __forceinline__ DlConsts dl_consts(const float* logscale,
                                              float binsize, float inv_bin) {
  DlConsts c;
  c.binsize = binsize;
  c.inv_bin = inv_bin;
  c.scale = expf(__ldg(logscale));
  c.rscale = __frcp_rn(c.scale);
  c.step = __fdiv_rn(binsize, c.scale);
  c.mark = c.scale >= 0x1p-64f && c.scale <= 0x1p64f;
  return c;
}

// a / s correctly rounded, as __fdiv_rn(a, s). MARK: through the scale's
// correctly rounded reciprocal rs (Markstein's correction): q = a * rs,
// the residual a - q * s exact in one FMA, and q + residual * rs rounded
// once; three instructions where __fdiv_rn takes ten and a branch. The
// kernels take it for s in [2^-64, 2^64] (c.mark), far from overflow; it
// was the correctly rounded quotient on every element of the card tests
// (dmean, which divides by s twice over, bitwise equal to the twin's).
template <bool MARK>
__device__ __forceinline__ float div_scale(float a, const DlConsts& c) {
  if (!MARK) return __fdiv_rn(a, c.scale);
  const float q = __fmul_rn(a, c.rscale);
  return __fmaf_rn(__fmaf_rn(-q, c.scale, a), c.rscale, q);
}

// x = (floor(sample / b) * b - mean) / s; hi = sigmoid(x + b/s), lo =
// sigmoid(x), sigmoid(v) = 1 / (1 + exp(-v)).
template <bool POW2, bool MARK>
__device__ __forceinline__ void dl_terms(float mean, float smp,
                                         const DlConsts& c, float& x,
                                         float& hi, float& lo) {
  const float q = POW2 ? __fmul_rn(smp, c.inv_bin) : __fdiv_rn(smp, c.binsize);
  x = div_scale<MARK>(__fsub_rn(__fmul_rn(floorf(q), c.binsize), mean), c);
  hi = __frcp_rn(__fadd_rn(1.f, expf(-__fadd_rn(x, c.step))));
  lo = __frcp_rn(__fadd_rn(1.f, expf(-x)));
}

template <bool POW2, bool MARK>
__device__ __forceinline__ float dl_logp(float mean, float smp,
                                         const DlConsts& c) {
  float x, hi, lo;
  dl_terms<POW2, MARK>(mean, smp, c, x, hi, lo);
  return logf(__fadd_rn(__fsub_rn(hi, lo), 1e-7f));
}

// dmean for upstream gradient g; the element's share of dlogscale is
// subtracted from ``part``. sigmoid' as autograd takes it, (g * (1 - y)) *
// y; d(x)/d(logscale) = -x and d(x + b/s)/d(logscale) = -(x + b/s).
template <bool POW2, bool MARK>
__device__ __forceinline__ float dl_grad(float mean, float smp, float g,
                                         const DlConsts& c, float& part) {
  float x, hi, lo;
  dl_terms<POW2, MARK>(mean, smp, c, x, hi, lo);
  const float gd = __fdiv_rn(g, __fadd_rn(__fsub_rn(hi, lo), 1e-7f));
  const float d_hi = __fmul_rn(__fmul_rn(gd, __fsub_rn(1.f, hi)), hi);
  const float d_lo = __fmul_rn(__fmul_rn(-gd, __fsub_rn(1.f, lo)), lo);
  const float dx = __fadd_rn(d_hi, d_lo);
  part = __fsub_rn(part, __fadd_rn(__fmul_rn(dx, x), __fmul_rn(d_hi, c.step)));
  return -div_scale<MARK>(dx, c);
}

// A row slice is read as float4 (VEC) or as floats.
template <bool VEC> struct Pack {
  using T = float4;
  static constexpr int LANES = 4, ITEMS = DL_VEC;
};
template <> struct Pack<false> {
  using T = float;
  static constexpr int LANES = 1, ITEMS = 4 * DL_VEC;
};

__device__ __forceinline__ float& lane(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ float& lane(float& v, int) { return v; }

// The block's sum of v, in every thread: a warp-shuffle tree, then the
// warps' sums in warp order. ``red`` holds DL_WARPS floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < DL_WARPS; ++w) s = __fadd_rn(s, red[w]);
  return s;
}

// The cluster's sum of the blocks' sums ``mine`` (thread 0's), in rank
// order, in thread 0 of block 0; ``slot`` is the block's shared float that
// its peers read. Every block of the cluster calls it.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float mine, float* slot) {
  if (threadIdx.x == 0) *slot = mine;
  cluster.sync();
  float total = 0.f;
  if (cluster.block_rank() == 0 && threadIdx.x == 0)
    for (unsigned b = 0; b < cluster.num_blocks(); ++b)
      total = __fadd_rn(total, *cluster.map_shared_rank(slot, b));
  cluster.sync();   // the peers' shared memory lives until block 0 has read it
  return total;
}

// Block ``rank`` of a row's cluster takes elements [c0, c1) of the row.
struct Slice {
  size_t row;
  int c0, c1;
};

__device__ __forceinline__ Slice slice(const cg::cluster_group& cluster,
                                       int row_len, int chunk) {
  Slice s;
  s.row = blockIdx.x / cluster.num_blocks();
  s.c0 = min(row_len, static_cast<int>(cluster.block_rank()) * chunk);
  s.c1 = min(row_len, s.c0 + chunk);
  return s;
}

// The sum of K4's terms over this thread's elements of a slice of n
// vectors (T = float4 or float): each round loads ITEMS vectors of each
// input a thread, all before the round's arithmetic.
template <bool VEC, bool POW2, bool MARK>
__device__ __forceinline__ float dl_fwd_slice(const float* mean,
                                              const float* sample, int n,
                                              const DlConsts& c) {
  using T = typename Pack<VEC>::T;
  constexpr int LANES = Pack<VEC>::LANES, ITEMS = Pack<VEC>::ITEMS;
  const T* m = reinterpret_cast<const T*>(mean);
  const T* s = reinterpret_cast<const T*>(sample);
  float acc = 0.f;
  for (int r = threadIdx.x; r < n; r += DL_THREADS * ITEMS) {
    T mv[ITEMS], sv[ITEMS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int i = r + u * DL_THREADS;
      if (i < n) {
        mv[u] = __ldg(m + i);
        sv[u] = __ldg(s + i);
      }
    }
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      if (r + u * DL_THREADS < n) {
#pragma unroll
        for (int k = 0; k < LANES; ++k)
          acc = __fadd_rn(acc, dl_logp<POW2, MARK>(lane(mv[u], k),
                                                   lane(sv[u], k), c));
      }
    }
  }
  return acc;
}

// The backward over the same elements: writes their dmean for the row's
// upstream gradient g and returns their share of dlogscale.
template <bool VEC, bool POW2, bool MARK>
__device__ __forceinline__ float dl_bwd_slice(const float* mean,
                                              const float* sample,
                                              float* dmean, float g, int n,
                                              const DlConsts& c) {
  using T = typename Pack<VEC>::T;
  constexpr int LANES = Pack<VEC>::LANES, ITEMS = Pack<VEC>::ITEMS;
  const T* m = reinterpret_cast<const T*>(mean);
  const T* s = reinterpret_cast<const T*>(sample);
  T* dm = reinterpret_cast<T*>(dmean);
  float acc = 0.f;
  for (int r = threadIdx.x; r < n; r += DL_THREADS * ITEMS) {
    T mv[ITEMS], sv[ITEMS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int i = r + u * DL_THREADS;
      if (i < n) {
        mv[u] = __ldg(m + i);
        sv[u] = __ldg(s + i);
      }
    }
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int i = r + u * DL_THREADS;
      if (i < n) {
        T o;
#pragma unroll
        for (int k = 0; k < LANES; ++k)
          lane(o, k) = dl_grad<POW2, MARK>(lane(mv[u], k), lane(sv[u], k), g,
                                           c, acc);
        dm[i] = o;
      }
    }
  }
  return acc;
}

template <bool VEC, bool POW2>
__global__ void __launch_bounds__(DL_THREADS)
dl_fwd_kernel(const float* __restrict__ mean, const float* __restrict__ sample,
              const float* __restrict__ logscale, float* __restrict__ out,
              int row_len, int chunk, float binsize, float inv_bin) {
  constexpr int LANES = Pack<VEC>::LANES;
  __shared__ float red[DL_WARPS];
  __shared__ float slot;
  cg::cluster_group cluster = cg::this_cluster();
  const Slice sl = slice(cluster, row_len, chunk);
  const size_t base = sl.row * row_len + sl.c0;
  const int n = (sl.c1 - sl.c0) / LANES;
  const DlConsts c = dl_consts(logscale, binsize, inv_bin);
  const float acc =
      c.mark ? dl_fwd_slice<VEC, POW2, true>(mean + base, sample + base, n, c)
             : dl_fwd_slice<VEC, POW2, false>(mean + base, sample + base, n, c);
  const float total = cluster_sum(cluster, block_sum(acc, red), &slot);
  if (cluster.block_rank() == 0 && threadIdx.x == 0) out[sl.row] = total;
}

template <bool VEC, bool POW2>
__global__ void __launch_bounds__(DL_THREADS)
dl_bwd_kernel(const float* __restrict__ mean, const float* __restrict__ sample,
              const float* __restrict__ logscale, const float* __restrict__ g,
              float* __restrict__ dmean, float* part, float* dlogscale,
              int* counter, int rows, int row_len, int chunk, float binsize,
              float inv_bin) {
  constexpr int LANES = Pack<VEC>::LANES;
  __shared__ float red[DL_WARPS];
  __shared__ float slot;
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  const Slice sl = slice(cluster, row_len, chunk);
  const size_t base = sl.row * row_len + sl.c0;
  const int n = (sl.c1 - sl.c0) / LANES;
  const DlConsts c = dl_consts(logscale, binsize, inv_bin);
  const float gr = __ldg(g + sl.row);
  const float acc =
      c.mark ? dl_bwd_slice<VEC, POW2, true>(mean + base, sample + base,
                                             dmean + base, gr, n, c)
             : dl_bwd_slice<VEC, POW2, false>(mean + base, sample + base,
                                              dmean + base, gr, n, c);
  const float total = cluster_sum(cluster, block_sum(acc, red), &slot);
  if (cluster.block_rank() != 0) return;
  // the grid ticket: block 0 of each row's cluster
  if (threadIdx.x == 0) {
    part[sl.row] = total;
    __threadfence();
    last = atomicAdd(counter, 1) == rows - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float v = 0.f;
  for (int i = threadIdx.x; i < rows; i += DL_THREADS)
    v = __fadd_rn(v, __ldcg(part + i));
  v = block_sum(v, red);
  if (threadIdx.x == 0) {
    dlogscale[0] = v;
    *counter = 0;
  }
}

__global__ void __launch_bounds__(DL_THREADS) dl_empty_kernel(int) {}

// Elements of a row that each block of a cluster of ``splits`` takes: a
// multiple of 4, so that every block's slice of an aligned row is aligned.
static int dl_chunk(int row_len, int splits) {
  return ((row_len + splits - 1) / splits + 3) / 4 * 4;
}

static bool dl_valid(int rows, int row_len, int splits) {
  return rows > 0 && row_len > 0 &&
         (splits == 1 || splits == 2 || splits == 4 || splits == 8) &&
         static_cast<long long>(rows) * splits <= INT_MAX;
}

static bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One block of DL_THREADS for each of ``splits`` parts of each row, in
// clusters of ``splits``.
struct DlLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  DlLaunch(int rows, int splits, void* stream) : attr{}, cfg{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = splits;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(rows * splits);
    cfg.blockDim = dim3(DL_THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

static int dl_status(cudaError_t launched) {
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

extern "C" {

// out [rows] = K4 of mean and sample [rows, row_len] (f32, contiguous) for
// the one-element logscale, with each row split over ``splits`` blocks.
// pow2: binsize is a power of two whose reciprocal is a normal float.
// Returns cudaGetLastError() after the launch (0 on success).
int dl_fwd(const float* mean, const float* sample, const float* logscale,
           float* out, int rows, int row_len, int splits, float binsize,
           int pow2, void* stream) {
  if (!dl_valid(rows, row_len, splits)) return cudaErrorInvalidValue;
  const bool vec = row_len % 4 == 0 && aligned16(mean) && aligned16(sample);
  void (*kern)(const float*, const float*, const float*, float*, int, int,
               float, float) = dl_fwd_kernel<false, false>;
  if (vec && pow2) kern = dl_fwd_kernel<true, true>;
  else if (vec) kern = dl_fwd_kernel<true, false>;
  else if (pow2) kern = dl_fwd_kernel<false, true>;
  DlLaunch l(rows, splits, stream);
  return dl_status(cudaLaunchKernelEx(&l.cfg, kern, mean, sample, logscale,
                                      out, row_len, dl_chunk(row_len, splits),
                                      binsize, pow2 ? 1.f / binsize : 0.f));
}

// K4's backward for the upstream gradient g [rows]: dmean [rows, row_len]
// and dlogscale [1]; part [rows] is scratch for the rows' shares of
// dlogscale, counter one int32 that is 0 before the launch and after it.
int dl_bwd(const float* mean, const float* sample, const float* logscale,
           const float* g, float* dmean, float* part, float* dlogscale,
           int* counter, int rows, int row_len, int splits, float binsize,
           int pow2, void* stream) {
  if (!dl_valid(rows, row_len, splits)) return cudaErrorInvalidValue;
  const bool vec = row_len % 4 == 0 && aligned16(mean) && aligned16(sample) &&
                   aligned16(dmean);
  void (*kern)(const float*, const float*, const float*, const float*, float*,
               float*, float*, int*, int, int, int, float, float) =
      dl_bwd_kernel<false, false>;
  if (vec && pow2) kern = dl_bwd_kernel<true, true>;
  else if (vec) kern = dl_bwd_kernel<true, false>;
  else if (pow2) kern = dl_bwd_kernel<false, true>;
  DlLaunch l(rows, splits, stream);
  return dl_status(cudaLaunchKernelEx(
      &l.cfg, kern, mean, sample, logscale, g, dmean, part, dlogscale, counter,
      rows, row_len, dl_chunk(row_len, splits), binsize,
      pow2 ? 1.f / binsize : 0.f));
}

// An empty kernel on the grid and clusters of a call with ``rows`` rows
// split ``splits`` ways: the launch floor, for measurement only.
int dl_launch_floor(int rows, int splits, void* stream) {
  if (!dl_valid(rows, 1, splits)) return cudaErrorInvalidValue;
  DlLaunch l(rows, splits, stream);
  return dl_status(cudaLaunchKernelEx(&l.cfg, dl_empty_kernel, 0));
}

}  // extern "C"
