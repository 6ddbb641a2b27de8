// K1: the whole masked AR conv net of one IAF step, fused, for Hopper.
//
// Replaces iaf_tpu/ops/ar_stack.py:_stack_kernel (:115, pallas_call at
// :219, entry ar_stack_fused :268). Computes, per image, the chain
//   h1 = ELU(conv(z, W0) + b0 + ctx)        z: cz -> ch, zero-diagonal centre
//   h_i = ELU(conv(h_{i-1}, W_i) + b_i)     ch -> ch   (depth_ar - 1 times)
//   out = conv(h_last, W_out) + b_out       ch -> cout (merged m|s heads)
// with 3x3 stride-1 SAME convs whose weights arrive folded (V/|V|*g*mask):
// a 3x3 raster AR mask leaves only the taps (0,0) (0,1) (0,2) (1,0) (1,1)
// nonzero, so each conv is a sum over those five taps and the four dead
// ones are never computed. Each conv's input is rounded to T where it
// enters the product (as the Pallas kernel rounds at each matmul input);
// accumulation, bias, context add and ELU are f32. Under autograd the
// hidden convs' f32 pre-activations are written too (K1's backward reads
// them).
//
// The mask makes every conv causal in rows: output row y reads input rows
// y-1 and y only. The TPU kernel kept 4 whole images and a [4,18,18,160]
// f32 scratch in 16 MB of VMEM; a Hopper block has 227 KB. Two kernels,
// the first in two instantiations (and two walks of the launch plan each):
//
// * ar_stack_wgmma_kernel, bf16 at W = 16 (the paper config), on the
//   tensor cores. Persistent blocks, one per SM, each walking whole images
//   over the SMs (the whole-image plan; fewer images than SMs take bands,
//   below); an image is walked as tiles of 8 rows (128 pixels: two
//   half-image tiles at H = 16), top to bottom. A block is two consumer
//   warpgroups (warp r computes row r of the tile, 16 pixels, so each
//   warpgroup is one m64 of wgmma) and one producer warp.
//   - Activations stay on chip. z's rows (the tile's 8 and the one above)
//     are staged with 16-byte cp.async, the next tile's while the hidden
//     convs run. Each hidden conv's output goes from the accumulators
//     (bias from shared memory, ctx for conv 0, f32 pre-activation to
//     device memory when asked, ELU, rounded to bf16) into the next conv's
//     input buffer, 8 rows x 18 columns (a zero column each side) x
//     (ch + CPAD) channels; two buffers alternate along the chain. The row
//     above a tile is each conv input's halo row, kept aside per conv
//     (6 KB each at ch = 160): the last row's warp copies it there once
//     the conv has read it, and writes zeros after an image's last tile.
//     Per tile and conv one barrier of the consumers; only z, ctx, the
//     heads and the pre-activations touch device memory.
//   - Weights and ctx: the producer streams every conv's (tap, 32-deep K
//     chunk) slices, packed for all convs in one launch (ar_pack_w_kernel)
//     in masked_conv.cuh's wgmma B order, each conv's input channels
//     padded with zeros to whole chunks (so no wgmma is conditional, which
//     ptxas would serialize), through a ring of cp.async.bulk stages with
//     mbarriers, running ahead across conv and tile bounds. After conv 0's
//     slices it streams the tile's 8 ctx rows (one row, 16 x ch f32, a
//     stage): read in the epilogue as plain loads, ctx cost a memory
//     latency per 8 columns.
//   - Math: wgmma.mma_async m64nNk16 with A from registers (ldmatrix.x4
//     from the staged rows, each lane its own pixel's address), B from the
//     ring, f32 accumulators; N is the conv's width rounded up to an
//     instantiated one (160 for the hidden convs, 64 for the heads at the
//     paper widths), its padding columns zero and never stored. N = 256
//     is compiled into a second instantiation only (NMAX).
// * The same kernel for f32 at W = 16 (ar_stack_wgmma_kernel<160, true>,
//   the f32 recipe's every call at the paper widths), on the tensor cores
//   by 3xTF32: Hopper has no f32 tensor-core product and one TF32 product
//   keeps ~11 bits, so each f32 operand x is split into hi = tf32(x) and
//   lo = tf32(x - hi) (round to nearest, ties away) and every product is
//   lo*hi + hi*lo + hi*hi, small terms first (~2^-21 relative per
//   product; lo*lo is below f32's own rounding). A is split in registers
//   after ldmatrix (each 32-bit word one element: the four 8x8 b16
//   matrices are the tf32 A fragment); B, the weights, stream as f32 (4
//   bytes, not a pre-split 8) in KF = 8-deep slices, and three splitter
//   warps walk the ring beside the producer, splitting each landed slice
//   in place (hi over it, lo after it) before the consumers may read it
//   (a third mbarrier per stage, ready; ctx rows pass through). The
//   tensor cores' own sums lose ~1/3 ulp of the running sum per wgmma
//   (measured: 1.0e-5 of the output's max from the f64 twin on a 3-conv
//   chain, 2.0e-5 on 8), so each 4 slices' sum is added into f32 totals
//   rounded to nearest, which doubles the accumulators: the producer's
//   warpgroup hands registers to the consumers (setmaxnreg, 224 a
//   consumer thread). f32 buffers are twice bf16's: one hidden buffer,
//   each conv's output written over its input once every warp has read
//   it (a consumer barrier between the mainloop and the epilogue; the
//   last row's warp keeps the halo row first); 8 stages and at most 8
//   convs at the paper widths.
// * ar_stack_kernel, the shapes the tensor-core kernel does not tile (W !=
//   16, channels not in whole k-steps, f32 with cz over 64 or ch or cout
//   over 160): FP32 FMA on the CUDA cores, one block per image walking
//   its rows as a wavefront with a ring of two padded rows per conv input
//   in shared memory, one thread per output channel of PX neighbouring
//   pixels, weights coalesced across output channels from L1/L2.
//
// Bound on the H100 (paper widths: cz=32, ch=160, cout=64, 3 convs, bf16):
// at the eval shape (N = 1024 images of 16x16) 107.4 GFLOP over the live
// taps, 0.109 ms at 989 TFLOP/s, against ~252 MB of compulsory traffic,
// 0.075 ms at 3.35 TB/s: bound by operations. At the training shape
// (batch 32, pre-activations written) 3.4 GFLOP against 18.8 MB (z 0.5,
// ctx 5.2, heads 2.1, pre-activations 10.5, weights 0.4): 5.6 us, bound
// by bytes. What the design does: the chain never leaves the SM (the
// bytes are the compulsory ones), the tensor cores run wgmma, and at batch
// 32 every image is its own block (32 blocks). What bounds it instead
// (PERF.md): a tile's critical path, the same at both shapes. Each
// slice waits for its own wgmma (as K2's forward does), and the three
// epilogues (a third of the time) run while the tensor cores idle, both
// warpgroups held by the barrier between convs; the L2 weight stream
// (410 KB a tile pass, 0.84 GB a launch at N = 1024) costs little beside
// them. Tried and worse: 64-deep slices, and overlapping a slice's wgmma
// with the next slice's ldmatrix (wait_group 1). Untried: warpgroups
// synchronised by row flags instead of a barrier (warpgroup 0 never waits
// for warpgroup 1 within a tile), so one's epilogue overlaps the other's
// products; two blocks of a cluster sharing each weight slice by TMA
// multicast.
// Fewer images than SMs (the inversion's 2, recon's 16, the training
// step's batch 32): one block an image left most SMs idle, each walking
// its image's two tiles in turn. Done (the launch plan, Item below, from
// ops/ar_stack.py fwd_plan): bands of 9 - n_convs rows, one tile each
// that computes again the rows above the band the chain reaches back to
// (2 at the paper's 3 convs: bands of 6 rows, 3 an image, 96 blocks at
// batch 32). Every stored value keeps its arithmetic, so both plans give
// the same bits. Device ms a call, H100 SXM at 700 W, against the
// whole-image plan in the same run (PERF.md): N = 2 f32 0.226 -> 0.114
// (cuDNN's three f32 convs 0.120), N = 16 bf16 0.050 -> 0.027, batch 32
// with the pre-activations bf16 0.051 -> 0.028 and f32 0.225 -> 0.115. At
// N = 1024 bands walked several a block took 1.46x (bf16) and 1.48x (f32)
// the whole-image plan's time (24 one-tile items a block against 8 images
// of two tiles), so it keeps that plan. Tried and taken out: a cluster of
// 2 or 4 blocks that split every conv's output channels, exchanging each
// hidden conv's output through distributed shared memory (N = 2 f32
// 0.066 ms, but invert_check only 7.6 % faster, less than its run-to-run
// spread, for a third walk that spilled in f32; bf16 gained 1-2 % at
// N = 16).
// In f32 the same 107.4 GFLOP are three TF32 products each: 322 GFLOP at
// 495 TFLOP/s, 0.65 ms at N = 1024 (~268 MB compulsory, 0.08 ms); the
// f32 weight stream is 0.82 MB a tile pass, 1.7 GB a launch from L2. Any
// kernel with exact f32 products on the CUDA cores has 107.4 GFLOP at 67
// TFLOP/s, ~1.6 ms, as its floor. The f32 kernel's critical path is the
// bf16 one's with twice the slices per K (each waiting for its own three
// wgmmas) and a flush of 80 sums a thread every 4 slices.
//
// Types: T = float or __nv_bfloat16 for z, weights and the on-chip
// activations; ctx, biases, accumulation and the output are f32.

#include <type_traits>

#include "masked_conv.cuh"

// Convs in one chain: the kernel arguments carry one weight, bias and
// pre-activation pointer per conv. Shared memory binds first: at the paper
// widths (W=16, cz=32, ch=160) a block holds 16 convs on the tensor cores
// in bf16 and 8 in f32 (ar_stack_smem_bytes).
#define MAX_CONVS 32
#define NTAPS 5

struct StackArgs {
  const void* z;              // [N,H,W,cz] T
  const float* ctx;           // [N,H,W,ch] f32
  const void* w[MAX_CONVS];   // packed weights of conv i, T
  const float* b[MAX_CONVS];  // [cout_i] f32
  float* out;                 // [N,H,W,cout] f32
  // [N,H,W,ch] f32 pre-activation of hidden conv i (before its ELU), or
  // null: written only when the caller will run the backward
  float* pre[MAX_CONVS - 1];
  int n_convs, H, W, cz, ch, cout;
};

// Channels in and out of conv i: z's for the first, ch between, the heads'
// for the last.
__device__ __forceinline__ int conv_cin(const StackArgs& a, int i) {
  return i == 0 ? a.cz : a.ch;
}
__device__ __forceinline__ int conv_cout(const StackArgs& a, int i) {
  return i == a.n_convs - 1 ? a.cout : a.ch;
}
// Sum of the input widths of convs 0..i-1: where conv i's ring starts, in
// channels per ring column (FMA path).
__host__ __device__ static inline size_t chans_before(int i, int cz, int ch) {
  return i == 0 ? 0 : (size_t)cz + (size_t)(i - 1) * ch;
}

__host__ __device__ static inline int ring_width(int W) { return W + 2 + PX; }

// Shared memory of the FMA path: for conv i, two padded rows
// [2][W+2+PX][cin_i] of T.
static size_t smem_bytes(int n_convs, int W, int cz, int ch, size_t elem) {
  return (size_t)2 * ring_width(W) * chans_before(n_convs, cz, ch) * elem;
}

template <typename T>
__global__ void ar_stack_kernel(StackArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = blockIdx.x;
  const int H = a.H, W = a.W, RW = ring_width(W);
  // conv i's ring: [2][RW][cin_i] of T, after the rings of convs 0..i-1
  T* const rings = reinterpret_cast<T*>(smem);
  auto ring = [&](int i) {
    return rings + (size_t)2 * RW * chans_before(i, a.cz, a.ch);
  };
  // Zero once: the padding columns and the row above the image stay zero.
  const size_t off = (size_t)2 * RW * chans_before(a.n_convs, a.cz, a.ch) *
                     sizeof(T);
  uint32_t* s32 = reinterpret_cast<uint32_t*>(smem);
  for (size_t i = threadIdx.x; i < off / 4; i += blockDim.x) s32[i] = 0u;
  __syncthreads();

  const T* __restrict__ z =
      static_cast<const T*>(a.z) + (size_t)n * H * W * a.cz;
  const float* __restrict__ ctx = a.ctx + (size_t)n * H * W * a.ch;
  float* __restrict__ out = a.out + (size_t)n * H * W * a.cout;
  const int ngroups = (W + PX - 1) / PX;

  for (int y = 0; y < H; ++y) {
    const int s = y & 1, p = s ^ 1;  // ring slots of rows y and y-1
    T* zrow = ring(0) + ((size_t)s * RW + 1) * a.cz;
    const T* zsrc = z + (size_t)y * W * a.cz;
    for (int i = threadIdx.x; i < W * a.cz; i += blockDim.x) zrow[i] = zsrc[i];
    __syncthreads();

    for (int c = 0; c < a.n_convs; ++c) {
      const int ci_n = conv_cin(a, c), co_n = conv_cout(a, c);
      const T* src = ring(c);
      const T* __restrict__ wt = static_cast<const T*>(a.w[c]);
      const float* __restrict__ bias = a.b[c];
      const bool last = (c == a.n_convs - 1);
      for (int item = threadIdx.x; item < co_n * ngroups;
           item += blockDim.x) {
        const int co = item % co_n;
        const int x0 = (item / co_n) * PX;
        float acc[PX];
#pragma unroll
        for (int q = 0; q < PX; ++q) acc[q] = 0.f;
#pragma unroll
        for (int t = 0; t < NTAPS; ++t) {
          // live taps in packing order: (0,0) (0,1) (0,2) (1,0) (1,1)
          const int slot = t < 3 ? p : s;
          const int dx = t < 3 ? t : t - 3;
          // padded column x+dx holds pixel x+dx-1
          const T* arow = src + ((size_t)slot * RW + x0 + dx) * ci_n;
          const T* wcol = wt + (size_t)t * ci_n * co_n + co;
          for (int ci = 0; ci < ci_n; ++ci) {
            const float wv = to_f(wcol[(size_t)ci * co_n]);
#pragma unroll
            for (int q = 0; q < PX; ++q)
              acc[q] = fmaf(to_f(arow[q * ci_n + ci]), wv, acc[q]);
          }
        }
        const float bv = bias[co];
#pragma unroll
        for (int q = 0; q < PX; ++q) {
          const int x = x0 + q;
          if (x >= W) break;
          float v = acc[q] + bv;
          if (c == 0) v += ctx[((size_t)y * W + x) * a.ch + co];
          if (last) {
            out[((size_t)y * W + x) * a.cout + co] = v;
          } else {
            if (a.pre[c] != nullptr)
              a.pre[c][(((size_t)n * H + y) * W + x) * a.ch + co] = v;
            v = elu(v);
            ring(c + 1)[((size_t)s * RW + x + 1) * co_n + co] = from_f<T>(v);
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
static int launch(const StackArgs& a, int n_images, int threads,
                  cudaStream_t stream) {
  const size_t smem =
      smem_bytes(a.n_convs, a.W, a.cz, a.ch, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      ar_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ar_stack_kernel<T><<<n_images, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core path (W = 16): ar_stack_wgmma_kernel<NMAX, F32>, bf16 (F32 =
// false) or f32 by 3xTF32 (F32 = true). See the note at the top; the
// staged-row copy, barriers, ldmatrix, descriptors and wgmma are
// masked_conv.cuh's (K2's forward).
// ---------------------------------------------------------------------------

#define TR 8         // rows per tile: 8 rows x 16 pixels = 128 = 2 x m64
#define TW 16        // the only width the kernel tiles: one warp per row
#define SCOL 18      // staged columns: pixel x at column x + 1
#define KF 8         // f32: K depth of one weight slice (one k8 step)
#define FLUSH 4      // f32: slices summed on the tensor cores per flush

// What the two instantiations differ in: the activations' element size,
// a slice's K depth, the channel padding (16 bytes, so the 8 rows of an
// ldmatrix phase fall in distinct bank groups) and the block.
template <bool F32>
struct WgPath {
  static constexpr int E = F32 ? 4 : 2;
  static constexpr int KS = F32 ? KF : KC;
  static constexpr int PAD = 16 / E;
  static constexpr int THREADS = F32 ? TF_THREADS : WG_THREADS;
};

// A conv's K as the kernel runs it: its input channels padded with zeros
// to whole ``ks``-deep slices (zero weight rows, zero buffer channels), so
// no wgmma is conditional (bf16: two k16 steps a slice; f32: one k8).
__host__ __device__ static inline int wg_k(int c, int ks = KC) {
  return (c + ks - 1) / ks * ks;
}

// The wgmma N of a conv with ``c`` outputs: the narrowest instantiated
// width that holds them (masked_conv.py WGMMA_WIDTHS).
__host__ __device__ static inline int wg_width(int c) {
  return c <= 32 ? 32 : c <= 64 ? 64 : c <= 128 ? 128 : c <= 160 ? 160 : 256;
}

// Shared memory of one block: the ring's mbarriers (full and empty, and
// for f32 ready), z's buffer (the tile's 8 rows and the one above), the
// hidden buffers (bf16: two alternate along the chain, one for a two-conv
// chain; f32: one, each conv's output written over its input), one halo
// row per hidden conv input, every conv's bias (f32, conv c's from c * ch
// on), then the ring of ``slice``-byte stages from ``fixed`` on (a weight
// slice, or one image row of ctx). An f32 stage holds the landed KF-deep
// f32 slice, whose hi part is written over it, and its lo part after it.
struct WgLayout {
  int bars, zbytes, hbytes, halo, nbuf, bias, fixed, slice;
};

__host__ __device__ static inline WgLayout wg_layout(int n_convs, int cz,
                                                     int ch, int cout,
                                                     bool f32) {
  const int e = f32 ? 4 : 2, ks = f32 ? KF : KC, pad = 16 / e;
  WgLayout L;
  L.bars = (f32 ? 3 : 2) * MAX_STAGES * 8;
  L.zbytes = round128((TR + 1) * SCOL * (wg_k(cz, ks) + pad) * e);
  L.hbytes = round128(TR * SCOL * (wg_k(ch, ks) + pad) * e);
  L.halo = SCOL * (wg_k(ch, ks) + pad) * e;
  L.nbuf = !f32 && n_convs > 2 ? 2 : 1;
  L.bias = L.bars + L.zbytes + L.nbuf * L.hbytes + (n_convs - 1) * L.halo;
  L.fixed = round128(L.bias + ((n_convs - 1) * ch + cout) * 4);
  const int np = wg_width(ch) > wg_width(cout) ? wg_width(ch)
                                                : wg_width(cout);
  L.slice = f32 ? 2 * KF * np * 4 : KC * np * 2;
  return L;
}

// The launch plan (ops/ar_stack.py fwd_plan): work items of ``band`` rows
// of one image (band = H: whole images), each walked by one block. An
// item's rows are [r0, r1); its tiles start at t0 = max(0, r0 - (n_convs
// - 1)), so the rows above r0 that the chain reaches back to (conv c's
// output row y reads z rows y - 1 - c .. y) are computed again, with zero
// halo rows: where t0 > 0 those should have held image rows, which leaves
// conv c's first c tile rows wrong, all of them above r0. Heads and
// pre-activations are stored for rows r0 .. r1 - 1 only, so every row by
// one block. Each stored value is the same arithmetic as on the whole-
// image walk (the same products of the same operands in the same order),
// so the plans agree bit for bit. BANDS: the banded walk's instantiation;
// without it the item is the whole image, as constants, and the walk's
// code is the one from before plans.
struct Item {
  int img, r0, r1, t0, tiles;
};

template <bool BANDS>
__device__ __forceinline__ Item work_item(int w, int H, int band,
                                          int n_convs) {
  if constexpr (!BANDS) return Item{w, 0, H, 0, (H + TR - 1) / TR};
  const int bands = (H + band - 1) / band;
  Item it;
  it.img = w / bands;
  it.r0 = (w - it.img * bands) * band;
  it.r1 = it.r0 + band < H ? it.r0 + band : H;
  it.t0 = it.r0 > n_convs - 1 ? it.r0 - (n_convs - 1) : 0;
  it.tiles = (it.r1 - it.t0 + TR - 1) / TR;
  return it;
}

// One conv of one tile by one consumer warp, N its wgmma width: the
// mainloop over the 5 live taps and the K slices of each (``cin`` = wg_k
// of the input channels; A rows: ``above`` and ``here``, shared addresses
// of the input rows y-1 and y of this warp's output row, column 0; B: the
// ring, each stage waited for on ``full``: for f32 the splitters' ready
// barriers), then the epilogue from the accumulators (``bias``: this
// conv's in shared memory; for conv 0 the tile's 8 ctx rows follow its
// weight slices through the ring, row r read by warp r), ``before`` run
// by every consumer just before the stores. ``img``, ``y``: the image and
// row this warp computes (rows y >= H are computed and not stored; in the
// banded walk, BANDS, only the item's rows ``r0`` .. ``r1`` - 1 are).
template <int N, bool F32, bool BANDS, typename Before>
__device__ __forceinline__ void wg_conv(
    const StackArgs& a, int c, uint32_t above, uint32_t here, int cin,
    unsigned char* ring, int slice, uint64_t* full, uint64_t* empty,
    int stages, int& stage, int& phase, unsigned char* next, int img,
    int y, int r0, int r1, const float* bias, Before before) {
  typedef WgPath<F32> P;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int cs = cin + P::PAD;
  // ldmatrix.x4: lanes 0-15 give pixel rows 0-15 at a k-step's first 16
  // bytes of K, lanes 16-31 the same rows at its next 16 (bf16: k 0-7 and
  // 8-15 of a k16 step; f32: k 0-3 and 4-7 of a k8 step, each 32-bit word
  // one element, so the four matrices are the tf32 A fragment)
  const uint32_t lane_off = (lane & 15) * cs * P::E + (lane >> 4) * 16;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  // f32: acc sums FLUSH slices on the tensor cores, then goes into tot in
  // f32 (round to nearest): the tensor cores' sums lose ~1/3 ulp of the
  // running sum per wgmma, so a short run keeps that loss small
  float tot[F32 ? N / 2 : 1];
  int run = 0;
  if constexpr (F32) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) tot[i] = 0.f;
  }
#pragma unroll 1
  for (int t = 0; t < NTAPS; ++t) {
    // taps (0,0) (0,1) (0,2) read row y-1, (1,0) (1,1) row y; pixel x's
    // tap dx reads column x + dx
    const uint32_t arow =
        (t < 3 ? above + t * cs * P::E : here + (t - 3) * cs * P::E) +
        lane_off;
    for (int k0 = 0; k0 < cin; k0 += P::KS) {
      if constexpr (F32) {
        // 3xTF32, one k8 step: lo*hi + hi*lo + hi*hi, small terms first
        uint32_t hi[4], lo[4];
        ldmatrix_x4(hi, arow + k0 * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) tf32_split(hi[i], hi[i], lo[i]);
        mbar_wait(&full[stage], phase);
        __syncwarp();
        const uint32_t base = smem_u32(ring + stage * slice);
        const uint64_t dhi = b_desc(base), dlo = b_desc(base + KF * N * 4);
        wgmma_fence();
        wgmma_tf32_rs<N>(acc, lo, dhi, run != 0);
        wgmma_tf32_rs<N>(acc, hi, dlo, 1);
        wgmma_tf32_rs<N>(acc, hi, dhi, 1);
      } else {
        uint32_t af[2][4];
        ldmatrix_x4(af[0], arow + k0 * 2);
        ldmatrix_x4(af[1], arow + (k0 + 16) * 2);
        mbar_wait(&full[stage], phase);
        __syncwarp();
        const uint64_t desc = b_desc(smem_u32(ring + stage * slice));
        wgmma_fence();
        wgmma_rs<N>(acc, af[0], desc);
        wgmma_rs<N>(acc, af[1], desc + ((16 * N * 2) >> 4));
      }
      wgmma_commit();
      wgmma_wait0();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
      if constexpr (F32) {
        if (++run == FLUSH || (t == NTAPS - 1 && k0 + KF >= cin)) {
#pragma unroll
          for (int i = 0; i < N / 2; ++i) tot[i] += acc[i];
          run = 0;
        }
      }
    }
  }
  if constexpr (F32) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = tot[i];
  }

  // Epilogue: bias (shared memory), then ctx for conv 0 (from the ring:
  // each warp waits for every ctx row's stage and adds its own row), in
  // the twin's order, (conv + b) + ctx.
  const bool inside = BANDS ? y >= r0 && y < r1 : y < a.H;
  const bool last = c == a.n_convs - 1;
  const int co_n = last ? a.cout : a.ch;
  const size_t pix = ((size_t)img * a.H + y) * TW + g;   // and pix + 8
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int co = j * 8 + 2 * tig;
    if (co < co_n) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + co);
      acc[4 * j] += bv.x;
      acc[4 * j + 1] += bv.y;
      acc[4 * j + 2] += bv.x;
      acc[4 * j + 3] += bv.y;
    }
  }
  if (c == 0) {
    const int r = threadIdx.x >> 5;
    for (int rr = 0; rr < TR; ++rr) {
      mbar_wait(&full[stage], phase);
      if (rr == r) {
        // [16 pixels][ch] f32: pixel g and g + 8 of this row
        const float* row =
            reinterpret_cast<const float*>(ring + stage * slice) + g * a.ch;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int co = j * 8 + 2 * tig;
          if (co < co_n) {
            const float2 c0 = *reinterpret_cast<const float2*>(row + co);
            const float2 c1 =
                *reinterpret_cast<const float2*>(row + 8 * a.ch + co);
            acc[4 * j] += c0.x;
            acc[4 * j + 1] += c0.y;
            acc[4 * j + 2] += c1.x;
            acc[4 * j + 3] += c1.y;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  before();
  if (last) {
    if (!inside) return;
    float* out = a.out + pix * a.cout;
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
    return;
  }
  const int ch = a.ch, ncs = wg_k(ch, P::KS) + P::PAD;
  float* pre = a.pre[c] != nullptr && inside ? a.pre[c] + pix * ch : nullptr;
  // this warp's row of the next conv's input, pixel g at column g + 1
  typedef typename std::conditional<F32, float, __nv_bfloat16>::type T;
  T* dst = reinterpret_cast<T*>(next) +
           ((size_t)(threadIdx.x >> 5) * SCOL + g + 1) * ncs;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int co = j * 8 + 2 * tig;
    if (co < ch) {
      if (pre != nullptr) {
        *reinterpret_cast<float2*>(pre + co) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(pre + 8 * ch + co) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      if constexpr (F32) {
        *reinterpret_cast<float2*>(dst + co) =
            make_float2(elu(acc[4 * j]), elu(acc[4 * j + 1]));
        *reinterpret_cast<float2*>(dst + 8 * ncs + co) =
            make_float2(elu(acc[4 * j + 2]), elu(acc[4 * j + 3]));
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst + co) =
            __floats2bfloat162_rn(elu(acc[4 * j]), elu(acc[4 * j + 1]));
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * ncs + co) =
            __floats2bfloat162_rn(elu(acc[4 * j + 2]), elu(acc[4 * j + 3]));
      }
    }
  }
}

// The weights are packed for all convs back to back (ar_pack_w_kernel),
// a.w[c] pointing at conv c's block (bf16: [5][wg_k(cin)/16][npad/8][2]
// [8][8]; f32: [5][wg_k(cin, KF)/8][npad/8][2][8][4]), so one (tap, K
// slice) slice is contiguous and each k-step in it is one canonical B
// operand. ``stages`` ring stages of L.slice bytes. NMAX: the widest N
// instantiated (160, or 256 for bf16 chains wider than 160: N = 256 needs
// 128 accumulator registers a thread, and compiled in it makes the kernel
// spill and the paper widths slower; f32 takes widths up to 160). The
// walk follows the plan (see Item): work items w = 0 .. n_images *
// ceil(H / band) - 1, handed to the blocks in turn; BANDS: band < H.
template <int NMAX, bool F32, bool BANDS>
__global__ void __launch_bounds__(WgPath<F32>::THREADS, 1)
    ar_stack_wgmma_kernel(StackArgs a, int n_images, int stages, int band) {
  typedef WgPath<F32> P;
  typedef typename std::conditional<F32, float, __nv_bfloat16>::type T;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  // f32: the consumers wait for the splitters' ready, not for the copy
  uint64_t* ready = F32 ? empty + MAX_STAGES : full;
  const WgLayout L = wg_layout(a.n_convs, a.cz, a.ch, a.cout, F32);
  unsigned char* zbuf = smem + L.bars;
  unsigned char* hbuf = zbuf + L.zbytes;      // buffer i at i * L.hbytes
  unsigned char* halos = hbuf + L.nbuf * L.hbytes;
  unsigned char* ring = smem + L.fixed;
  const int H = a.H;
  const int items = BANDS ? n_images * ((H + band - 1) / band) : n_images;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS / 32);
      if (F32) mbar_init(&ready[s], 32 * SPLIT_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // zero the buffers and halos once: the padding columns and channels
  // stay zero, and so does every halo until a tile's last row is copied
  // there
  for (int i = L.bars / 16 + tid; i < L.bias / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  float* biases = reinterpret_cast<float*>(smem + L.bias);
  for (int c = 0; c < a.n_convs; ++c)
    for (int i = tid; i < conv_cout(a, c); i += blockDim.x)
      biases[c * a.ch + i] = a.b[c][i];
  __syncthreads();

  if (warp >= WG_CONSUMERS / 32) {
    // the producer (one thread) streams every conv's slices and the ctx
    // rows through the ring; for f32 the splitters (the producer
    // warpgroup's other warps) walk the same order, split each weight
    // slice as it lands and pass the ctx rows on, and the warpgroup hands
    // registers to the consumers
    if constexpr (F32) reg_dealloc<TF_PRODUCER_REGS>();
    const bool producer = warp == WG_CONSUMERS / 32;
    if (producer && lane != 0) return;
    const int sl = (warp - WG_CONSUMERS / 32 - 1) * 32 + lane;
    int stage = 0, phase = 0;
    auto next_stage = [&]() {
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const Item it = work_item<BANDS>(w, H, band, a.n_convs);
      for (int tile = 0; tile < it.tiles; ++tile) {
        for (int c = 0; c < a.n_convs; ++c) {
          const int cin = wg_k(c == 0 ? a.cz : a.ch, P::KS);
          const int np = wg_width(c == a.n_convs - 1 ? a.cout : a.ch);
          const T* wp = static_cast<const T*>(a.w[c]);
          for (int t = 0; t < NTAPS; ++t) {
            for (int k0 = 0; k0 < cin; k0 += P::KS) {
              unsigned char* dst = ring + stage * L.slice;
              if (producer) {
                const int bytes = P::KS * np * P::E;
                mbar_wait(&empty[stage], phase ^ 1);
                mbar_expect_tx(&full[stage], bytes);
                bulk_g2s(dst, wp + ((size_t)t * cin + k0) * np, bytes,
                         &full[stage]);
              } else if constexpr (F32) {
                mbar_wait(&full[stage], phase);
                tf32_split_slice(dst, KF * np, sl, 32 * SPLIT_WARPS);
                fence_proxy_async();
                mbar_arrive(&ready[stage]);
              }
              next_stage();
            }
          }
          for (int r = 0; c == 0 && r < TR; ++r) {
            // the tile's ctx rows (16 x ch f32, within a slice); a row
            // past the image completes its stage empty
            const int yy = it.t0 + tile * TR + r;
            if (producer) {
              mbar_wait(&empty[stage], phase ^ 1);
              if (yy < H) {
                const int bytes = TW * a.ch * 4;
                mbar_expect_tx(&full[stage], bytes);
                bulk_g2s(ring + stage * L.slice,
                         a.ctx + ((size_t)it.img * H + yy) * TW * a.ch,
                         bytes, &full[stage]);
              } else {
                mbar_arrive(&full[stage]);
              }
            } else if constexpr (F32) {
              mbar_wait(&full[stage], phase);
              mbar_arrive(&ready[stage]);
            }
            next_stage();
          }
        }
      }
    }
    return;
  }

  // consumers: warp r computes row r of each tile
  if constexpr (F32) reg_alloc<TF_CONSUMER_REGS>();
  const int r = warp;
  const int zcs = wg_k(a.cz, P::KS) + P::PAD;
  const int hcs = wg_k(a.ch, P::KS) + P::PAD;
  // z's rows staged as 2-byte units (an f32 channel is two)
  const int zu = a.cz * P::E / 2;
  const RowCopy copy(tid, WG_CONSUMERS, zu, TW);
  const __nv_bfloat16* __restrict__ z =
      static_cast<const __nv_bfloat16*>(a.z);
  // z rows y0-1 .. y0+7 of image img (zeros outside it) into zbuf
  auto stage_z = [&](int img, int y0) {
    copy.rows(smem_u32(zbuf), z + (size_t)img * H * TW * zu, zu, y0 - 1,
              TR + 1, H, TW, SCOL, zcs * P::E / 2, 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // conv c's input buffer (c >= 1)
  auto input = [&](int c) {
    return F32 ? hbuf : hbuf + ((c - 1) & 1) * L.hbytes;
  };
  // conv c's input row 7 is the next tile's halo row (zeros after the
  // item's last tile); warp 7 alone writes that row, once every warp has
  // read the old one
  auto keep_halo = [&](int c, bool last_tile) {
    const uint4* src =
        reinterpret_cast<const uint4*>(input(c) + (TR - 1) * L.halo);
    uint4* dst = reinterpret_cast<uint4*>(halos + (c - 1) * L.halo);
    for (int i = lane; i < L.halo / 16; i += 32)
      dst[i] = last_tile ? make_uint4(0, 0, 0, 0) : src[i];
    __syncwarp();
  };

  int stage = 0, phase = 0;
  if (blockIdx.x < items) {
    const Item it = work_item<BANDS>(blockIdx.x, H, band, a.n_convs);
    stage_z(it.img, it.t0);
  }
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item it = work_item<BANDS>(w, H, band, a.n_convs);
    const int img = it.img;
    for (int tile = 0; tile < it.tiles; ++tile) {
      const int y = it.t0 + tile * TR + r;
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      consumers_sync();   // z has landed; the last tile's halos are kept
      for (int c = 0; c < a.n_convs; ++c) {
        uint32_t above, here;
        int cin;
        if (c == 0) {
          cin = wg_k(a.cz, P::KS);
          above = smem_u32(zbuf) + r * SCOL * zcs * P::E;
          here = above + SCOL * zcs * P::E;
        } else {
          cin = wg_k(a.ch, P::KS);
          here = smem_u32(input(c)) + r * SCOL * hcs * P::E;
          above = r == 0 ? smem_u32(halos + (c - 1) * L.halo)
                         : here - SCOL * hcs * P::E;
        }
        unsigned char* next = F32 ? hbuf : hbuf + (c & 1) * L.hbytes;
        // f32 writes conv c's output over its input: first every warp
        // must have read the input, and its row 7 be kept as a halo
        auto before = [&]() {
          if (F32 && c > 0) {
            consumers_sync();
            if (r == TR - 1) keep_halo(c, tile + 1 == it.tiles);
          }
        };
        const int np = wg_width(conv_cout(a, c));
        const float* cb = biases + c * a.ch;
        switch (np) {
#define AR_CONV(NN)                                                      \
  wg_conv<NN, F32, BANDS>(a, c, above, here, cin, ring, L.slice, ready,  \
                          empty, stages, stage, phase, next, img, y,     \
                          it.r0, it.r1, cb, before)
          case 32: AR_CONV(32); break;
          case 64: AR_CONV(64); break;
          case 128: AR_CONV(128); break;
          case 160: AR_CONV(160); break;
          default:
            if constexpr (NMAX == 256) AR_CONV(256);
#undef AR_CONV
        }
        consumers_sync();   // conv c's output is in place, its input read
        if (c == 0) {
          // z is free: stage the next tile's (this item's or the next's)
          if (tile + 1 < it.tiles) {
            stage_z(img, it.t0 + (tile + 1) * TR);
          } else if (w + (int)gridDim.x < items) {
            const Item nx =
                work_item<BANDS>(w + gridDim.x, H, band, a.n_convs);
            stage_z(nx.img, nx.t0);
          }
        } else if (!F32 && r == TR - 1) {
          keep_halo(c, tile + 1 == it.tiles);
        }
      }
    }
  }
}

// The instantiation for a walk: f32 takes widths up to 160, bf16 up to 256
// (``wide``: the NMAX = 256 one).
typedef void (*WgKernel)(StackArgs, int, int, int);
template <bool BANDS>
static WgKernel wg_kernel(bool f32, bool wide) {
  return f32 ? ar_stack_wgmma_kernel<160, true, BANDS>
         : wide ? ar_stack_wgmma_kernel<256, false, BANDS>
                : ar_stack_wgmma_kernel<160, false, BANDS>;
}

static int launch_wgmma(const StackArgs& a, int n_images, size_t limit,
                        bool f32, int band, int blocks,
                        cudaStream_t stream) {
  const WgLayout L = wg_layout(a.n_convs, a.cz, a.ch, a.cout, f32);
  const long fit = ((long)limit - L.fixed) / L.slice;
  const int stages = (int)(fit < MAX_STAGES ? fit : MAX_STAGES);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  // the plan: items of ``band`` rows handed to ``blocks`` blocks in turn
  if (band < 1 || blocks < 1 ||
      blocks > n_images * ((a.H + band - 1) / band))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)L.fixed + (size_t)stages * L.slice;
  const bool wide = L.slice > KC * 160 * 2;
  const WgKernel kernel = band < a.H ? wg_kernel<true>(f32, wide)
                                     : wg_kernel<false>(f32, wide);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, f32 ? TF_THREADS : WG_THREADS, smem, stream>>>(
      a, n_images, stages, band);
  return (int)cudaGetLastError();
}

// The forward weights of every conv in one launch, packed back to back:
// conv c's 5 live taps ((dy, dx) = (t / 3, t % 3), the first 5 in raster
// order) in masked_conv.cuh's wgmma B order with K = cin padded to
// wg_k(cin) (bf16: 32-deep slices; f32: KF = 8-deep) and N = cout padded to
// npad. A k-step is 16 bf16 or 8 f32 of K (32 bytes), as two halves h of
// KI = 8 or 4: element [t][s][j][h][n][k] = W[t][2 KI s + KI h + k][8 j +
// n], zero for 8 j + n >= cout or past cin, from item start[c] on. One
// item is one (t, s, j, h, n): KI loads of the strided weights (the model
// hands K1 permuted views), one 16-byte store. f32 is packed as it is:
// the kernel's splitters split each slice as it lands.
#define PK_THREADS 256

struct PackArgs {
  const void* w[MAX_CONVS];           // [3][3][cin][cout], any strides
  long long st[MAX_CONVS][4];         // its strides in elements
  int cin[MAX_CONVS], cout[MAX_CONVS], npad[MAX_CONVS];
  int start[MAX_CONVS + 1];           // each conv's first item
  uint4* out;
  int n;
};

template <bool F32>
__global__ void __launch_bounds__(PK_THREADS) ar_pack_w_kernel(PackArgs a) {
  constexpr int KI = F32 ? 4 : 8;
  const int i = blockIdx.x * PK_THREADS + threadIdx.x;
  if (i >= a.start[a.n]) return;
  int c = 0;
  while (i >= a.start[c + 1]) ++c;
  const int cin = a.cin[c], cout = a.cout[c], jn = a.npad[c] / 8;
  const int ks = wg_k(cin, F32 ? KF : KC) / (2 * KI);
  int r = i - a.start[c];
  const int n = r & 7;
  r >>= 3;
  const int h = r & 1;
  r >>= 1;
  const int j = r % jn;
  r /= jn;
  const int s = r % ks, t = r / ks;
  const int co = 8 * j + n;
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (co < cout && 2 * KI * s < cin) {   // cin % (2 KI) == 0
    const long long* st = a.st[c];
    const long long off = (t / 3) * st[0] + (t % 3) * st[1] +
                          (2 * KI * s + KI * h) * st[2] + co * st[3];
    if constexpr (F32) {
      const float* src = static_cast<const float*>(a.w[c]) + off;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __float_as_uint(src[k * st[2]]);
    } else {
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(a.w[c]) +
                                 off;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k >> 1] |= (uint32_t)__bfloat16_as_ushort(src[k * st[2]])
                     << (16 * (k & 1));
    }
  }
  a.out[i] = make_uint4(v[0], v[1], v[2], v[3]);
}

extern "C" {

// Bytes of dynamic shared memory one block needs at least (the wrapper
// checks it against the 227 KB a Hopper block may use): wgmma = 0 counts
// the FMA path's rings, 1 the tensor-core path's (bf16, or f32 by 3xTF32)
// buffers, halos and two weight stages (the launch takes every further
// stage that fits).
size_t ar_stack_smem_bytes(int n_convs, int W, int cz, int ch, int cout,
                           int bf16, int wgmma) {
  if (wgmma) {
    const WgLayout L = wg_layout(n_convs, cz, ch, cout, !bf16);
    return (size_t)L.fixed + 2 * (size_t)L.slice;
  }
  return smem_bytes(n_convs, W, cz, ch, bf16 ? 2 : 4);
}

// The tensor-core path's weights of ``n`` convs in one launch (bf16, or
// f32 with ``f32``) into ``out`` (16-byte aligned), conv after conv: ``w``
// a host array of device pointers, ``dims`` n triples (cin, cout, npad)
// with cin % 16 == 0 (f32: % 8), npad % 8 == 0 and cout <= npad,
// ``strides`` n quadruples (each weight's [3][3][cin][cout] strides in
// elements). Conv c's block, 5 * wg_k(cin) * npad elements (f32: wg_k(cin,
// KF)), follows those of the convs before it.
int ar_stack_pack_w(const void* const* w, void* out, const int* dims,
                    const long long* strides, int n, int f32, void* stream) {
  if (n < 1 || n > MAX_CONVS || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const int ki = f32 ? 4 : 8;
  PackArgs a;
  a.n = n;
  a.out = static_cast<uint4*>(out);
  a.start[0] = 0;
  for (int c = 0; c < n; ++c) {
    const int cin = dims[3 * c], cout = dims[3 * c + 1],
              npad = dims[3 * c + 2];
    if (cin % (2 * ki) || npad % 8 || cout > npad)
      return (int)cudaErrorInvalidValue;
    a.w[c] = w[c];
    for (int d = 0; d < 4; ++d) a.st[c][d] = strides[4 * c + d];
    a.cin[c] = cin;
    a.cout[c] = cout;
    a.npad[c] = npad;
    a.start[c + 1] = a.start[c] + 5 * wg_k(cin, f32 ? KF : KC) * npad / ki;
  }
  const int blocks = (a.start[n] + PK_THREADS - 1) / PK_THREADS;
  auto kernel = f32 ? ar_pack_w_kernel<true> : ar_pack_w_kernel<false>;
  kernel<<<blocks, PK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 on success). w and b are
// host arrays of n_convs device pointers (weights: [5][cin][cout] T on the
// FMA path, ar_stack_pack_w's per conv on the tensor cores; biases); pre
// is null or a host array of n_convs - 1 device pointers, each null or
// where that hidden conv's f32 pre-activation goes. wgmma = 1 takes the
// tensor-core kernel within ``limit`` bytes of shared memory (W = 16; z,
// ctx and the weights 16-byte aligned; bf16: cz and ch multiples of 16
// and cout of 8, all at most 256; f32, by 3xTF32: cz, ch and cout
// multiples of 8, cz at most 64, ch and cout at most 160) on the plan
// ``band``, ``blocks`` (ops/ar_stack.py fwd_plan: the whole-image plan is
// band = H, blocks = min(n_images, SMs)), 0 the FMA kernel with
// ``threads`` a block (one block an image; the plan is not read).
int ar_stack_fwd(const void* z, const void* ctx, const void* const* w,
                 const void* const* b, void* out, void* const* pre,
                 int n_convs, int n_images, int H, int W, int cz, int ch,
                 int cout, int bf16, int wgmma, int threads, int band,
                 int blocks, size_t limit, void* stream) {
  if (n_convs < 2 || n_convs > MAX_CONVS) return (int)cudaErrorInvalidValue;
  StackArgs a = {};
  a.z = z;
  a.ctx = static_cast<const float*>(ctx);
  for (int i = 0; i < n_convs; ++i) {
    a.w[i] = w[i];
    a.b[i] = static_cast<const float*>(b[i]);
    if (pre != nullptr && i < n_convs - 1)
      a.pre[i] = static_cast<float*>(pre[i]);
  }
  a.out = static_cast<float*>(out);
  a.n_convs = n_convs;
  a.H = H;
  a.W = W;
  a.cz = cz;
  a.ch = ch;
  a.cout = cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    bool ok = W == TW && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(ctx) % 16 == 0;
    if (bf16)
      ok = ok && cz % 16 == 0 && ch % 16 == 0 && cout % 8 == 0 &&
           cz <= 256 && ch <= 256 && cout <= 256;
    else
      ok = ok && cz % 8 == 0 && ch % 8 == 0 && cout % 8 == 0 && cz <= 64 &&
           ch <= 160 && cout <= 160;
    for (int i = 0; i < n_convs; ++i)
      ok = ok && reinterpret_cast<uintptr_t>(w[i]) % 16 == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
    return launch_wgmma(a, n_images, limit, !bf16, band, blocks, s);
  }
  return bf16 ? launch<__nv_bfloat16>(a, n_images, threads, s)
              : launch<float>(a, n_images, threads, s);
}

}  // extern "C"
