// K2's implicit-GEMM core: one stride-1 SAME conv over a given list of live
// taps, NHWC in and out, shared by masked_conv.cu (the forward: f32 out)
// and masked_conv_bwd.cu (dgrad, the conv of the output gradient with the
// taps mirrored and the weights transposed per tap: out in the input's
// type; and wgrad, which stages its rows as the conv does).
//
// out[n, y, x, co] = sum over taps t, ci of
//     in[n, y + dy_t - ph, x + dx_t - pw, ci] * W[t][ci][co]
// with ph = (kh - 1) / 2, pw = (kw - 1) / 2 and zeros outside the image.
//
// Three kernels compute it:
//
// * conv_wgmma_kernel<N, Tout, WGS>, bf16 on the tensor cores: persistent
//   blocks, one per SM, each walking 128-pixel tiles (8 row segments of
//   16 pixels of one image). A block is two consumer warpgroups and one
//   producer warp. With WGS = 1 (the forward's 64-pixel plan, for
//   pixel counts whose 128-pixel tiles leave SMs idle: the training
//   step's batch 32 has 64 of them for 132 SMs) a block is one consumer
//   warpgroup on 64-pixel tiles (4 segments) and stages tr + span rows:
//   each pixel's sum is the same sequence of wgmmas, so both plans give
//   the same bits.
//   - Activations: the consumers stage the tile's input rows (halo rows
//     included, the SAME padding zero-filled by cp.async with source size
//     0; the column halo is zeroed once) with 16-byte cp.async into one of
//     two buffers while the other buffer's tile computes, so each input
//     byte is read once per tile and the copy hides behind the tensor
//     cores. The channel stride is padded by CPAD so the 8 pixel rows of
//     an ldmatrix phase fall in distinct 16-byte bank groups. Per-thread
//     copy offsets advance by carries, with no division in the loop.
//   - Weights: the producer streams each (tap, 32-deep K chunk) slice of
//     the live-tap weights, packed by the wrapper in wgmma's canonical
//     K-major layout (8x8 core matrices of 128 contiguous bytes, no
//     swizzle), into a ring of stages with cp.async.bulk and mbarriers
//     (full: bytes landed; empty: the 8 consumer warps are done with it).
//     Where every slice fits at once (32->160: 133 KB) they are loaded
//     once per block and stay.
//   - Math: wgmma.mma_async m64nNk16, A from registers (ldmatrix.x4, each
//     lane giving its own pixel's row address: the implicit-GEMM gather),
//     B from the ring through a shared-memory descriptor, f32 accumulators
//     in registers (N = cout rounded up to an instantiated width, the
//     padding columns zero and never stored). Each warp owns one 16-pixel
//     segment, each warpgroup 64 pixels. The accumulators go straight
//     from registers to the output, f32 (forward) or rounded once to bf16
//     (dgrad's dx).
// * conv_tf32_kernel<N, WGS>, f32 on the tensor cores by 3xTF32 (the
//   forward and dgrad of the f32 recipe), on the same tiles (WGS = 1: 64
//   pixels), ring and warp roles (the producer warp grown to a
//   warpgroup): Hopper has no f32 tensor-core
//   product and one TF32 product keeps ~11 bits, so each f32 operand x is
//   split into hi = tf32(x) and lo = tf32(x - hi) and every product is
//   lo*hi + hi*lo + hi*hi, small terms first, as K1's f32 forward does.
//   - Activations: staged as f32 rows with a 16-byte channel pad; the
//     ldmatrix.x4 of f32 rows gives the tf32 A fragment directly (each
//     32-bit word one element), split in registers. At cin = 160 one staged
//     buffer is 131 KB, so two do not fit: the kernel stages the next tile
//     into its one buffer after the mainloop, behind the epilogue (at cin
//     = 32 and 64, where two would fit, one is as fast, measured).
//   - Weights: streamed as f32 (4 bytes, not a pre-split 8: the L2 stream
//     of a tile pass is already 1.3 MB at 160->160) in TK = 16-deep slices
//     (two k8 steps) in the tf32 K-major layout, and three splitter warps
//     split each landed slice in place (hi over it, lo after it) before the
//     consumers may read it (a third mbarrier per stage, ready).
//   - Sums: the tensor cores' own sums lose ~1/3 ulp of the running sum per
//     wgmma, so each TK_FLUSH slices' sum (12 wgmmas) is added into f32
//     totals; the producer warpgroup hands registers to the consumers
//     (setmaxnreg) for the doubled accumulators. N <= 160.
// * conv_fma_kernel, FP32 FMA on the CUDA cores (the shapes the tensor-core
//   kernels do not tile, bf16 or f32): a block owns `tr` output rows of one image and stages the input rows they read
//   once, as f32 after rounding to the weights' type; one thread item is
//   one output channel of PX neighbouring pixels, activations broadcast
//   from shared memory, weights ([taps][cin][cout]) coalesced across
//   output channels.
//
// Types: Tin is the input's (T for the forward, f32 for dgrad's output
// gradient on the FMA path, bf16 on the tensor cores), Tw the weights',
// Tout the output's (f32 for the forward, T for dgrad's dx); accumulation
// is f32.

#pragma once

#include "common.cuh"

#define MAX_TAPS 64
#define CPAD 8
#define PX 8            // FMA path: output pixels per thread item
#define FMA_THREADS 256
#define WG_CONSUMERS 256         // tensor cores: two consumer warpgroups
#define WG_THREADS (WG_CONSUMERS + 32)  // and one producer warp
#define WG_TILE_SEGS 8           // 16-pixel row segments per tile (128
                                 // pixels; a warpgroup takes 4 of them)
#define KC 32                    // K depth of one weight slice
#define MAX_STAGES 32            // weight ring stages, at most
#define BAR_BYTES (2 * MAX_STAGES * 8)
#define TF_BAR_BYTES (3 * MAX_STAGES * 8)  // f32: full, empty and ready
#define TK 16                    // f32 (3xTF32): K depth of one weight slice
#define TK_FLUSH 2               // f32: slices summed on the tensor cores
                                 // between flushes into f32 totals
#define SPLIT_WARPS 3                    // f32: the slice splitters, and
#define TF_THREADS (WG_CONSUMERS + 128)  // the producer: one warpgroup
#define TF_CONSUMER_REGS 224             // f32: registers a consumer thread
#define TF_PRODUCER_REGS 56              // takes, and a producer-group one

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
__host__ __device__ static inline int staged_cols(int W, int kw,
                                                  int tensor_cores) {
  return (tensor_cores ? W : (W + PX - 1) / PX * PX) + kw - 1;
}

// Dynamic shared memory of one FMA-path block: (tr + dy_hi - dy_lo)
// staged rows of f32.
static size_t conv_smem_bytes(int tr, int W, int cin, int kw, int span) {
  return (size_t)(tr + span) * staged_cols(W, kw, 0) * cin * 4;
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
                       int kw, int threads, cudaStream_t stream) {
  const size_t smem =
      conv_smem_bytes(a.tr, a.W, a.cin, kw, a.dy_hi - a.dy_lo);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = n_images * ((a.H + a.tr - 1) / a.tr);
  kernel<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// --- the tensor-core path ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Bulk copy of ``bytes`` (a multiple of 16) from global to shared memory,
// completing on ``bar``'s transaction count.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same with each 8x8 matrix transposed: lanes give the addresses of
// the 16-byte rows of K (pixels), and the fragments come out as A rows of
// M (channels), the mma.sync A layout.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Shared-memory matrix descriptor of a K-major, unswizzled B operand: 8x8
// core matrices of 128 contiguous bytes, the two of a k16 step 128 bytes
// apart (leading byte offset), neighbouring 8-column groups 256 bytes
// apart (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// D[64 x N] += A[64 x 16] (registers, the mma.sync A-fragment layout per
// warp) * B[16 x N] (shared memory, through the descriptor).
template <int N>
__device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D[64 x N] += A[64 x 8] * B[8 x N] in TF32 (f32 accumulators): A from
// registers, the mma.sync m16n8k8 tf32 A layout per warp (a0 row g k tig,
// a1 row g + 8, a2 and a3 the same rows at k tig + 4; each a tf32 in the
// top 19 bits of 32), B from shared memory through the descriptor, K-major
// as wgmma requires for tf32 (8x4 f32 core matrices of 128 bytes, so a k8
// step spans 32 bytes of K like a bf16 k16 step and b_desc carries over).
// scale_d = 0 writes D = A * B, dropping what D held. Used by K1's f32
// forward (ar_stack.cu, three passes per f32 product).
template <int N>
__device__ void wgmma_tf32_rs(float* d, const uint32_t* a, uint64_t desc,
                              int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float* d, const uint32_t* a,
                                                  uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float* d, const uint32_t* a,
                                                  uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float* d, const uint32_t* a,
                                                  uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<160>(float* d, const uint32_t* a,
                                                  uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// x rounded to TF32 (round to nearest, ties away from zero), as the bits
// of an f32 whose low 13 mantissa bits are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

// The 3xTF32 split: x = hi + lo + O(2^-22 |x|), hi = tf32(x) and lo =
// tf32(x - hi) (x - hi is exact in f32).
__device__ __forceinline__ void tf32_split(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(__uint_as_float(x));
  lo = tf32_rna(__uint_as_float(x) - __uint_as_float(hi));
}

// A landed f32 slice of ``elems`` elements split in place, thread ``sl``
// of ``nthreads`` taking every nthreads-th float4: each element becomes
// its tf32 hi part there and its lo part at the same place ``elems``
// floats on.
__device__ __forceinline__ void tf32_split_slice(unsigned char* stage,
                                                 int elems, int sl,
                                                 int nthreads) {
  float4* hi = reinterpret_cast<float4*>(stage);
  float4* lo = hi + elems / 4;
  for (int i = sl; i < elems / 4; i += nthreads) {
    const float4 v = hi[i];
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) tf32_split(__float_as_uint(x[k]), h[k], l[k]);
    hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                        __uint_as_float(h[2]), __uint_as_float(h[3]));
    lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                        __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// Hand registers between warpgroups (all 128 threads of one execute it):
// a producer warpgroup gives up to R, consumers take up to R.
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads of them (wgmma's B operand).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Named barrier 1 over the block's ``THREADS`` consumer threads.
template <int THREADS = WG_CONSUMERS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

__host__ __device__ static inline int round128(int b) {
  return (b + 127) / 128 * 128;
}

// Bytes of one staged activation buffer: (tr + span) rows of W + kw - 1
// columns, cin channels and 16 bytes of padding, of ``e``-byte elements
// (bf16: CPAD channels; f32: 4).
__host__ __device__ static inline int wg_a_bytes(int tr, int W, int cin,
                                                 int kw, int span,
                                                 int e = 2) {
  return round128((tr + span) * staged_cols(W, kw, 1) * (cin + 16 / e) * e);
}

// Zeros the column halo of one staged buffer of SR rows (never
// overwritten by the row copies).
__device__ __forceinline__ void zero_halo(unsigned char* buf, int SR, int SC,
                                          int W, int cs, int pw, int tid,
                                          int nthreads) {
  const int halo = SC - W, chunks = cs / 8;   // uint4 per pixel
  for (int i = tid; i < SR * halo * chunks; i += nthreads) {
    const int c = i % chunks, rest = i / chunks;
    const int hc = rest % halo, r = rest / halo;
    const int col = hc < pw ? hc : W + hc;
    reinterpret_cast<uint4*>(buf)[(r * SC + col) * chunks + c] =
        make_uint4(0, 0, 0, 0);
  }
}

// The staged-row copy of ``cin`` channels by one thread among
// ``nthreads``: its first 16-byte chunk as mixed-radix digits (row,
// column, 8-channel chunk) and the stride between its chunks in the same
// digits, so that the copy loop advances by carries with no division.
struct RowCopy {
  int CH, ch0, c0, r0, dch, dcol, drow;
  __device__ RowCopy(int tid, int nthreads, int cin, int W)
      : CH(cin / 8),
        ch0(tid % (cin / 8)),
        c0((tid / (cin / 8)) % W),
        r0(tid / (cin / 8) / W),
        dch(nthreads % (cin / 8)),
        dcol((nthreads / (cin / 8)) % W),
        drow(nthreads / (cin / 8) / W) {}

  // cp.async of staged rows 0..SR-1 (image rows row0..row0+SR-1 of img,
  // whose pixels are ``stride`` channels apart; zeros outside the image)
  // into the buffer at shared address ``base``; the caller commits the
  // group.
  __device__ __forceinline__ void rows(uint32_t base,
                                       const __nv_bfloat16* img, int stride,
                                       int row0, int SR, int H, int W, int SC,
                                       int cs, int pw) const {
    int ch = ch0, c = c0, r = r0;
    while (r < SR) {
      const int yy = row0 + r;
      const bool inside = yy >= 0 && yy < H;
      cp_async16(base + ((r * SC + c + pw) * cs + ch * 8) * 2,
                 inside ? img + ((size_t)yy * W + c) * stride + ch * 8 : img,
                 inside ? 16 : 0);
      ch += dch;
      if (ch >= CH) {
        ch -= CH;
        ++c;
      }
      c += dcol;
      if (c >= W) {
        c -= W;
        ++r;
      }
      r += drow;
    }
  }
};

// The weights are packed [taps][cin/16 k-steps][N/8 column groups][2 k
// halves][8 columns][8 k] (bf16), so one (tap, 32-deep chunk) slice is
// contiguous and each k-step in it is one canonical B operand. WGS
// consumer warpgroups (2: 128-pixel tiles, 1: 64-pixel tiles) and one
// producer warp.
template <int N, typename Tout, int WGS = 2>
__global__ void __launch_bounds__(128 * WGS + 32, 1)
    conv_wgmma_kernel(ConvArgs a, int n_tiles, int stages, int resident) {
  constexpr int CONS = 128 * WGS;   // consumer threads
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  const int H = a.H, W = a.W, cin = a.cin, cs = cin + CPAD;
  const int SC = staged_cols(W, 2 * a.pw + 1, 1);
  const int SR = a.tr + a.dy_hi - a.dy_lo;
  const int a_bytes = wg_a_bytes(a.tr, W, cin, 2 * a.pw + 1,
                                 a.dy_hi - a.dy_lo);
  unsigned char* abuf = smem + BAR_BYTES;
  unsigned char* ring = abuf + 2 * a_bytes;
  const int nchunks = (cin + KC - 1) / KC;
  const int slice_bytes = KC * N * 2;
  const int tiles_y = (H + a.tr - 1) / a.tr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  zero_halo(abuf, SR, SC, W, cs, a.pw, tid, blockDim.x);
  zero_halo(abuf + a_bytes, SR, SC, W, cs, a.pw, tid, blockDim.x);
  __syncthreads();

  const __nv_bfloat16* __restrict__ wp =
      static_cast<const __nv_bfloat16*>(a.w);
  if (warp == CONS / 32) {
    // producer: one thread streams the weight slices through the ring
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int t = 0; t < a.ntaps; ++t) {
          for (int c = 0; c < nchunks; ++c) {
            const int kd = min(KC, cin - c * KC);
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], kd * N * 2);
            bulk_g2s(ring + stage * slice_bytes,
                     wp + ((size_t)t * cin + c * KC) * N, kd * N * 2,
                     &full[stage]);
            if (++stage == stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
        if (resident) break;
      }
    }
    return;
  }

  // consumers: warp w computes row segment w of the tile (warpgroup w / 4
  // owns segments 4(w/4) .. 4(w/4) + 3 as its 64 M rows, whichever WGS)
  const int segs = W / 16;
  const int ry = warp / segs, sx = (warp - ry * segs) * 16;
  const int g = lane >> 2, tig = lane & 3;
  // ldmatrix.x4: lanes 0-15 give pixel rows 0-15 at k 0-7, lanes 16-31
  // the same rows at k 8-15
  const int lane_off = ((ry * SC + sx + (lane & 15)) * cs + (lane >> 4) * 8)
                       * 2;
  const RowCopy copy(tid, CONS, cin, W);
  const __nv_bfloat16* __restrict__ in =
      static_cast<const __nv_bfloat16*>(a.in);

  auto stage_tile = [&](int tile, int buf) {
    const int n = tile / tiles_y, y0 = (tile - n * tiles_y) * a.tr;
    copy.rows(smem_u32(abuf + buf * a_bytes), in + (size_t)n * H * W * cin,
              cin, y0 + a.dy_lo - a.ph, SR, H, W, SC, cs, a.pw);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[N / 2];
  int stage = 0, phase = 0, buf = 0;
  if (blockIdx.x < n_tiles) stage_tile(blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    consumers_sync<CONS>();   // the tile has landed; the other buffer is
                              // free
    if (tile + (int)gridDim.x < n_tiles) stage_tile(tile + gridDim.x, buf ^ 1);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    const uint32_t abase = smem_u32(abuf + buf * a_bytes) + lane_off;
    for (int t = 0; t < a.ntaps; ++t) {
      const uint32_t atap =
          abase + (((a.tap_dy[t] - a.dy_lo) * SC + a.tap_dx[t]) * cs) * 2;
      for (int c = 0; c < nchunks; ++c) {
        const int kd = min(KC, cin - c * KC);
        uint32_t af[2][4];
        ldmatrix_x4(af[0], atap + c * KC * 2);
        if (kd > 16) ldmatrix_x4(af[1], atap + (c * KC + 16) * 2);
        mbar_wait(&full[stage], resident ? 0 : phase);
        __syncwarp();
        const uint64_t desc = b_desc(smem_u32(ring + stage * slice_bytes));
        wgmma_fence();
        wgmma_rs<N>(acc, af[0], desc);
        if (kd > 16) wgmma_rs<N>(acc, af[1], desc + ((16 * N * 2) >> 4));
        wgmma_commit();
        wgmma_wait0();
        if (!resident) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[stage]);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }

    const int n = tile / tiles_y, y = (tile - n * tiles_y) * a.tr + ry;
    if (y < H) {
      Tout* out = static_cast<Tout*>(a.out) +
                  (((size_t)n * H + y) * W + sx + g) * a.cout;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int co = j * 8 + 2 * tig;
        if (co < a.cout) {
          if constexpr (sizeof(Tout) == 4) {
            *reinterpret_cast<float2*>(out + co) =
                make_float2(acc[4 * j], acc[4 * j + 1]);
            *reinterpret_cast<float2*>(out + 8 * a.cout + co) =
                make_float2(acc[4 * j + 2], acc[4 * j + 3]);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out + co) =
                __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * a.cout + co) =
                __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
          }
        }
      }
    }
  }
}

// The same conv in f32 by 3xTF32 (f32 in and out), on conv_wgmma_kernel's
// tiles and ring: the weights packed [taps][cin/8][N/8][2][8][4] (f32, the
// tf32 K-major layout), one (tap, TK-deep chunk) slice contiguous and
// split in place by the producer warpgroup's three splitter warps; f32
// rows staged in one buffer (the next tile's copy is issued once every
// warp has read the tile, behind the stores). Kept apart from the bf16
// kernel: sharing one body cost the bf16 kernel registers and ~1.5 % of
// its time. WGS consumer warpgroups (2: 128-pixel tiles, 1: 64-pixel
// tiles) and the producer warpgroup. With two, the block's 384 threads
// share the SM's registers and setmaxnreg hands the consumers 224 each;
// with one, its 256 threads may each hold 255 and nothing is handed.
template <int N, int WGS = 2>
__global__ void __launch_bounds__(128 * WGS + 128, 1)
    conv_tf32_kernel(ConvArgs a, int n_tiles, int stages) {
  constexpr int CONS = 128 * WGS;   // consumer threads
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* ready = empty + MAX_STAGES;   // the split slice, for consumers
  const int H = a.H, W = a.W, cin = a.cin, cs = cin + 4;
  const int SC = staged_cols(W, 2 * a.pw + 1, 1);
  const int SR = a.tr + a.dy_hi - a.dy_lo;
  unsigned char* abuf = smem + TF_BAR_BYTES;
  unsigned char* ring =
      abuf + wg_a_bytes(a.tr, W, cin, 2 * a.pw + 1, a.dy_hi - a.dy_lo, 4);
  const int nchunks = cin / TK;
  const int slice_bytes = 2 * TK * N * 4;   // the landed slice, then lo
  const int tiles_y = (H + a.tr - 1) / a.tr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONS / 32);
      mbar_init(&ready[s], 32 * SPLIT_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the rows are staged as 2-byte units (an f32 channel is two)
  zero_halo(abuf, SR, SC, W, cs * 2, a.pw, tid, blockDim.x);
  __syncthreads();

  if (warp >= CONS / 32) {
    // the producer (one thread) streams the weight slices through the
    // ring; the splitters (the warpgroup's other warps) walk the same
    // order and split each slice as it lands; the warpgroup hands
    // registers to the consumers
    if constexpr (WGS == 2) reg_dealloc<TF_PRODUCER_REGS>();
    const bool producer = warp == CONS / 32;
    if (producer && lane != 0) return;
    const int sl = (warp - CONS / 32 - 1) * 32 + lane;
    const float* __restrict__ wp = static_cast<const float*>(a.w);
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      for (int t = 0; t < a.ntaps; ++t) {
        for (int c = 0; c < nchunks; ++c) {
          unsigned char* dst = ring + stage * slice_bytes;
          if (producer) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], TK * N * 4);
            bulk_g2s(dst, wp + ((size_t)t * cin + c * TK) * N, TK * N * 4,
                     &full[stage]);
          } else {
            mbar_wait(&full[stage], phase);
            tf32_split_slice(dst, TK * N, sl, 32 * SPLIT_WARPS);
            fence_proxy_async();
            mbar_arrive(&ready[stage]);
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warp w computes row segment w of the tile, as in
  // conv_wgmma_kernel
  if constexpr (WGS == 2) reg_alloc<TF_CONSUMER_REGS>();
  const int segs = W / 16;
  const int ry = warp / segs, sx = (warp - ry * segs) * 16;
  const int g = lane >> 2, tig = lane & 3;
  // ldmatrix.x4 on f32 rows: lanes 0-15 give pixel rows 0-15 at k 0-3 of
  // a k8 step, lanes 16-31 the same rows at k 4-7; each 32-bit word is one
  // element, so the four matrices are the tf32 A fragment
  const int lane_off = ((ry * SC + sx + (lane & 15)) * cs + (lane >> 4) * 4)
                       * 4;
  const RowCopy copy(tid, CONS, cin * 2, W);
  const __nv_bfloat16* __restrict__ in =
      static_cast<const __nv_bfloat16*>(a.in);

  auto stage_tile = [&](int tile) {
    const int n = tile / tiles_y, y0 = (tile - n * tiles_y) * a.tr;
    copy.rows(smem_u32(abuf), in + (size_t)n * H * W * cin * 2, cin * 2,
              y0 + a.dy_lo - a.ph, SR, H, W, SC, cs * 2, a.pw);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // acc sums TK_FLUSH slices on the tensor cores (their own sums lose ~1/3
  // ulp of the running sum per wgmma), then goes into tot in f32
  float acc[N / 2], tot[N / 2];
  int stage = 0, phase = 0;
  if (blockIdx.x < n_tiles) stage_tile(blockIdx.x);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    consumers_sync<CONS>();   // the tile has landed
#pragma unroll
    for (int i = 0; i < N / 2; ++i) tot[i] = 0.f;
    int run = 0;
    const uint32_t abase = smem_u32(abuf) + lane_off;
    for (int t = 0; t < a.ntaps; ++t) {
      const uint32_t atap =
          abase + ((a.tap_dy[t] - a.dy_lo) * SC + a.tap_dx[t]) * cs * 4;
      for (int c = 0; c < nchunks; ++c) {
        // two k8 steps: lo*hi + hi*lo + hi*hi, small terms first
        uint32_t hi[TK / 8][4], lo[TK / 8][4];
#pragma unroll
        for (int s = 0; s < TK / 8; ++s) {
          ldmatrix_x4(hi[s], atap + (c * TK + 8 * s) * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) tf32_split(hi[s][i], hi[s][i], lo[s][i]);
        }
        mbar_wait(&ready[stage], phase);
        __syncwarp();
        const uint32_t base = smem_u32(ring + stage * slice_bytes);
        const uint64_t dhi = b_desc(base), dlo = b_desc(base + TK * N * 4);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < TK / 8; ++s) {
          const uint64_t step = (8 * N * 4 * s) >> 4;
          wgmma_tf32_rs<N>(acc, lo[s], dhi + step, run != 0 || s != 0);
          wgmma_tf32_rs<N>(acc, hi[s], dlo + step, 1);
          wgmma_tf32_rs<N>(acc, hi[s], dhi + step, 1);
        }
        wgmma_commit();
        wgmma_wait0();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
        if (++run == TK_FLUSH || (t == a.ntaps - 1 && c == nchunks - 1)) {
#pragma unroll
          for (int i = 0; i < N / 2; ++i) tot[i] += acc[i];
          run = 0;
        }
      }
    }
    // every warp has read the buffer; the next tile's copy runs behind
    // this tile's stores
    consumers_sync<CONS>();
    if (next < n_tiles) stage_tile(next);

    const int n = tile / tiles_y, y = (tile - n * tiles_y) * a.tr + ry;
    if (y < H) {
      float* out = static_cast<float*>(a.out) +
                   (((size_t)n * H + y) * W + sx + g) * a.cout;
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
  }
}

// The tensor-core conv's shared memory at one shape within ``limit``
// bytes: the barriers, the staged activation buffers of ``a_bytes`` (bf16
// two, f32 one), then ``stages`` weight ring stages of ``slice`` bytes
// (bf16: one KC-deep slice; f32: one TK-deep slice and its lo part),
// ``smem`` in all. bf16 caps the stages at the slices a tile streams (all
// of them resident). Stages cap at MAX_STAGES; below 2 the shape does not
// fit.
struct WgPlan {
  int a_bytes, slice, stages;
  size_t smem;
};

static WgPlan wg_plan(int tr, int W, int cin, int kw, int span, int npad,
                      int ntaps, size_t limit, bool f32) {
  WgPlan p;
  const long bars = f32 ? TF_BAR_BYTES : BAR_BYTES;
  p.a_bytes = wg_a_bytes(tr, W, cin, kw, span, f32 ? 4 : 2);
  p.slice = f32 ? 2 * TK * npad * 4 : KC * npad * 2;
  const long abytes = (f32 ? 1L : 2L) * p.a_bytes;
  long s = ((long)limit - bars - abytes) / p.slice;
  if (s > MAX_STAGES) s = MAX_STAGES;
  const long slices = (long)ntaps * ((cin + KC - 1) / KC);
  if (!f32 && s > slices) s = slices;
  p.stages = (int)s;
  p.smem = bars + (size_t)abytes + (size_t)(s > 0 ? s : 0) * p.slice;
  return p;
}

// Rows of a tile of ``segs`` 16-pixel row segments (8: 128 pixels, 4:
// 64) at width W, or 0 where the tile is not whole rows (128 pixels: W of
// 16, 32, 64 or 128; 64 pixels: W of 16, 32 or 64).
__host__ __device__ static inline int wg_tile_rows(int W,
                                                   int segs = WG_TILE_SEGS) {
  if (W < 16 || W % 16 || segs % (W / 16)) return 0;
  return segs / (W / 16);
}

// Blocks of ``kernel`` (``threads`` a block, ``smem`` dynamic bytes) for
// ``n_tiles`` persistent tiles: as many as are resident on the card, at
// most one per tile, and how many are resident on one SM; 0 or the CUDA
// error.
template <typename K>
static int persistent_blocks(K kernel, int threads, size_t smem, int n_tiles,
                             int* blocks, int* resident) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  *resident = per_sm;
  return 0;
}

// Launches conv_wgmma_kernel<N, Tout, WGS> (bf16) or with F32
// conv_tf32_kernel<N, WGS> on ``a`` (its tr already the tile's rows: 128
// pixels with WGS = 2, 64 with WGS = 1): one persistent block per SM, at
// most one per tile. With ``query`` it launches nothing and writes the
// grid's blocks and the blocks resident on one SM there.
template <int N, typename Tout, bool F32, int WGS>
static int wgmma_launch(const ConvArgs& a, int n_images, int kw,
                        size_t limit, cudaStream_t stream, int* query) {
  const WgPlan p = wg_plan(a.tr, a.W, a.cin, kw, a.dy_hi - a.dy_lo, N,
                           a.ntaps, limit, F32);
  if (p.stages < 2) return (int)cudaErrorInvalidValue;
  const int n_tiles = n_images * ((a.H + a.tr - 1) / a.tr);
  int blocks = 0, per_sm = 0, e;
  if constexpr (F32) {
    constexpr int threads = 128 * WGS + 128;
    e = persistent_blocks(conv_tf32_kernel<N, WGS>, threads, p.smem,
                          n_tiles, &blocks, &per_sm);
    if (!e && !query) {
      conv_tf32_kernel<N, WGS><<<blocks, threads, p.smem, stream>>>(
          a, n_tiles, p.stages);
      e = (int)cudaGetLastError();
    }
  } else {
    constexpr int threads = 128 * WGS + 32;
    e = persistent_blocks(conv_wgmma_kernel<N, Tout, WGS>, threads, p.smem,
                          n_tiles, &blocks, &per_sm);
    if (!e && !query) {
      // the last argument: whether every slice stays resident
      const int slices = a.ntaps * ((a.cin + KC - 1) / KC);
      conv_wgmma_kernel<N, Tout, WGS><<<blocks, threads, p.smem, stream>>>(
          a, n_tiles, p.stages, p.stages >= slices);
      e = (int)cudaGetLastError();
    }
  }
  if (!e && query) {
    query[0] = blocks;
    query[1] = per_sm;
  }
  return e;
}

// wgmma_launch on 128-pixel tiles (wgs 2) or 64-pixel ones (wgs 1).
template <int N, typename Tout, bool F32>
static int wgmma_launch_tiles(int wgs, const ConvArgs& a, int n_images,
                              int kw, size_t limit, cudaStream_t s,
                              int* query) {
  return wgs == 1
             ? wgmma_launch<N, Tout, F32, 1>(a, n_images, kw, limit, s, query)
             : wgmma_launch<N, Tout, F32, 2>(a, n_images, kw, limit, s,
                                             query);
}

// The tensor-core conv of ``in`` (16-byte aligned) with the packed weights
// (their columns zero-padded to npad, one of 32, 64, 128, 160, 256; f32 at
// most 160) into ``out`` (Tout) over the ntaps (dy, dx) pairs of ``taps``:
// bf16 in and weights with cin % 16 == 0, or with F32 f32 in, weights and
// out by 3xTF32 with cin % TK == 0; cout even and <= npad; ``limit``:
// dynamic shared memory allowed; ``tile_pixels``: 128 (two consumer
// warpgroups a block) or 64 (one; the forward's plan for pixel counts
// whose 128-pixel tiles leave SMs idle, ``fwd_plan`` in masked_conv.py);
// ``query``: see wgmma_launch.
template <typename Tout, bool F32>
static int wgmma_conv(const void* in, const void* w, void* out,
                      const int* taps, int ntaps, int n_images, int H, int W,
                      int cin, int cout, int npad, int kh, int kw,
                      size_t limit, int tile_pixels, cudaStream_t s,
                      int* query = nullptr) {
  const int wgs = tile_pixels / 64;
  const int tr = tile_pixels % 64 || wgs < 1 || wgs > 2
                     ? 0
                     : wg_tile_rows(W, 4 * wgs);
  if (!tr || cin % (F32 ? TK : 16) || cout % 2 || cout > npad ||
      reinterpret_cast<uintptr_t>(in) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  int e = conv_prepare(a, in, w, out, taps, ntaps, H, W, cin, cout, kh, kw,
                       tr);
  if (e) return e;
  switch (npad) {
    case 32:
      return wgmma_launch_tiles<32, Tout, F32>(wgs, a, n_images, kw, limit,
                                               s, query);
    case 64:
      return wgmma_launch_tiles<64, Tout, F32>(wgs, a, n_images, kw, limit,
                                               s, query);
    case 128:
      return wgmma_launch_tiles<128, Tout, F32>(wgs, a, n_images, kw, limit,
                                                s, query);
    case 160:
      return wgmma_launch_tiles<160, Tout, F32>(wgs, a, n_images, kw, limit,
                                                s, query);
    case 256:
      // f32 at N = 256 would need 256 accumulator registers a thread
      if constexpr (!F32)
        return wgmma_launch_tiles<256, Tout, false>(wgs, a, n_images, kw,
                                                    limit, s, query);
      break;
  }
  return (int)cudaErrorInvalidValue;
}
