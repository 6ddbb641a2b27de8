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
// Design (conv_wgmma_kernel, bf16 on the tensor cores): persistent blocks,
// one per SM, each walking 128-pixel tiles (8 row segments of 16 pixels
// of one image). A block is two consumer warpgroups and one producer warp.
// * Activations: the consumers stage the tile's input rows (halo rows
//   included, the SAME padding zero-filled by cp.async with source size 0;
//   the column halo is zeroed once) with 16-byte cp.async into one of two
//   buffers while the other buffer's tile computes, so each input byte is
//   read once per tile and the copy hides behind the tensor cores. The
//   channel stride is padded by CPAD so the 8 pixel rows of an ldmatrix
//   phase fall in distinct 16-byte bank groups. Per-thread copy offsets
//   advance by carries, with no division in the loop.
// * Weights: the producer streams each (tap, 32-deep K chunk) slice of the
//   live-tap weights, packed by the wrapper in wgmma's canonical K-major
//   layout (8x8 core matrices of 128 contiguous bytes, no swizzle), into a
//   ring of stages with cp.async.bulk and mbarriers (full: bytes landed;
//   empty: the 8 consumer warps are done with it). Where every slice fits
//   at once (32->160: 133 KB) they are loaded once per block and stay.
// * Math: wgmma.mma_async m64nNk16, A from registers (ldmatrix.x4, each
//   lane giving its own pixel's row address: the implicit-GEMM gather), B
//   from the ring through a shared-memory descriptor, f32 accumulators in
//   registers (N = cout rounded up to an instantiated width, the padding
//   columns zero and never stored). Each warpgroup owns 64 pixels; the
//   accumulators go straight from registers to the f32 output.
//
// conv_fma_kernel (masked_conv.cuh) serves f32 and the shapes the
// tensor-core path does not tile.
//
// Entry points (plain C, loaded with ctypes): masked_conv_smem_bytes and
// masked_conv_fwd (FMA path), masked_conv_wgmma_stages and
// masked_conv_fwd_wgmma (tensor-core path).

#include "masked_conv.cuh"

#define WG_CONSUMERS 256         // two consumer warpgroups
#define WG_THREADS (WG_CONSUMERS + 32)  // and one producer warp
#define WG_TILE_SEGS 8           // 16-pixel row segments per tile
#define KC 32                    // K depth of one weight slice
#define MAX_STAGES 32            // weight ring stages, at most
#define BAR_BYTES (2 * MAX_STAGES * 8)

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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
}

__host__ __device__ static inline int round128(int b) {
  return (b + 127) / 128 * 128;
}

// Bytes of one staged activation buffer: (tr + span) rows of W + kw - 1
// columns, cin + CPAD channels, bf16.
__host__ __device__ static inline int wg_a_bytes(int tr, int W, int cin,
                                                 int kw, int span) {
  return round128((tr + span) * staged_cols(W, kw, 1) * (cin + CPAD) * 2);
}

// The weights are packed [taps][cin/16 k-steps][N/8 column groups][2 k
// halves][8 columns][8 k] (bf16), so one (tap, 32-deep chunk) slice is
// contiguous and each k-step in it is one canonical B operand.
template <int N>
__global__ void __launch_bounds__(WG_THREADS, 1)
    conv_wgmma_kernel(ConvArgs a, int n_tiles, int stages, int resident) {
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
      mbar_init(&empty[s], WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the column halo of both buffers: zeros, never overwritten
  {
    const int halo = SC - W, chunks = cs / 8;   // uint4 per pixel
    for (int i = tid; i < 2 * SR * halo * chunks; i += blockDim.x) {
      const int c = i % chunks, rest = i / chunks;
      const int hc = rest % halo, rb = rest / halo;  // rb: buffer * SR + row
      const int col = hc < a.pw ? hc : W + hc;
      const int b = rb / SR, r = rb - b * SR;
      reinterpret_cast<uint4*>(abuf + b * a_bytes)[(r * SC + col) * chunks +
                                                   c] = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  const __nv_bfloat16* __restrict__ wp =
      static_cast<const __nv_bfloat16*>(a.w);
  if (warp == WG_CONSUMERS / 32) {
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
  // owns segments 4(w/4) .. 4(w/4) + 3 as its 64 M rows)
  const int segs = W / 16;
  const int ry = warp / segs, sx = (warp - ry * segs) * 16;
  const int g = lane >> 2, tig = lane & 3;
  // ldmatrix.x4: lanes 0-15 give pixel rows 0-15 at k 0-7, lanes 16-31
  // the same rows at k 8-15
  const int lane_off = ((ry * SC + sx + (lane & 15)) * cs + (lane >> 4) * 8)
                       * 2;
  // the copy loop's mixed-radix digits (row, column, 8-channel chunk) of
  // this thread's first chunk and of the stride between its chunks
  const int CH = cin / 8;
  const int ch0 = tid % CH, c0 = (tid / CH) % W, r0 = tid / CH / W;
  const int dch = WG_CONSUMERS % CH, dcol = (WG_CONSUMERS / CH) % W;
  const int drow = WG_CONSUMERS / CH / W;
  const __nv_bfloat16* __restrict__ in =
      static_cast<const __nv_bfloat16*>(a.in);

  auto stage_tile = [&](int tile, int buf) {
    const int n = tile / tiles_y, y0 = (tile - n * tiles_y) * a.tr;
    const int row0 = y0 + a.dy_lo - a.ph;
    const __nv_bfloat16* img = in + (size_t)n * H * W * cin;
    const uint32_t base = smem_u32(abuf + buf * a_bytes);
    int ch = ch0, c = c0, r = r0;
    while (r < SR) {
      const int yy = row0 + r;
      const bool inside = yy >= 0 && yy < H;
      cp_async16(base + ((r * SC + c + a.pw) * cs + ch * 8) * 2,
                 inside ? img + ((size_t)yy * W + c) * cin + ch * 8 : img,
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
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[N / 2];
  int stage = 0, phase = 0, buf = 0;
  if (blockIdx.x < n_tiles) stage_tile(blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    consumers_sync();   // the tile has landed; the other buffer is free
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
      float* out = static_cast<float*>(a.out) +
                   (((size_t)n * H + y) * W + sx + g) * a.cout;
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
  }
}

// Weight ring stages for the tensor-core path within ``limit`` bytes of
// dynamic shared memory, capped at the slices a tile streams (all of them
// resident) and MAX_STAGES; below 2 the shape does not fit.
static int wg_stages(int tr, int W, int cin, int kw, int span, int npad,
                     int ntaps, size_t limit) {
  const long fixed = BAR_BYTES + 2L * wg_a_bytes(tr, W, cin, kw, span);
  const long slice = (long)KC * npad * 2;
  const long fit = ((long)limit - fixed) / slice;
  const long slices = (long)ntaps * ((cin + KC - 1) / KC);
  long s = fit < slices ? fit : slices;
  return (int)(s < MAX_STAGES ? s : MAX_STAGES);
}

template <int N>
static int wgmma_launch(const ConvArgs& a, int n_images, int kw,
                        size_t limit, cudaStream_t stream) {
  const int span = a.dy_hi - a.dy_lo;
  const int stages = wg_stages(a.tr, a.W, a.cin, kw, span, N, a.ntaps, limit);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int slices = a.ntaps * ((a.cin + KC - 1) / KC);
  const size_t smem = BAR_BYTES + 2 * (size_t)wg_a_bytes(a.tr, a.W, a.cin,
                                                         kw, span) +
                      (size_t)stages * KC * N * 2;
  cudaError_t e = cudaFuncSetAttribute(
      conv_wgmma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, conv_wgmma_kernel<N>, WG_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = n_images * ((a.H + a.tr - 1) / a.tr);
  const int blocks = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  conv_wgmma_kernel<N><<<blocks, WG_THREADS, smem, stream>>>(
      a, n_tiles, stages, stages >= slices);
  return (int)cudaGetLastError();
}

extern "C" {

// Bytes of dynamic shared memory one FMA-path block of ``tr`` output rows
// asks for (the wrapper picks tr so that this fits the 227 KB a Hopper
// block may use); span = dy_hi - dy_lo of the taps.
size_t masked_conv_smem_bytes(int tr, int W, int cin, int kw, int span,
                              int mma) {
  return conv_smem_bytes(tr, W, cin, kw, span, mma);
}

// Ring stages the tensor-core path gets within ``limit`` bytes at this
// shape (npad: cout rounded up to an instantiated width); it takes the
// shape when this is at least 2.
int masked_conv_wgmma_stages(int W, int cin, int kw, int span, int npad,
                             int ntaps, size_t limit) {
  if (W < 16 || W % 16 || WG_TILE_SEGS % (W / 16)) return 0;
  return wg_stages(WG_TILE_SEGS / (W / 16), W, cin, kw, span, npad, ntaps,
                   limit);
}

// out [N,H,W,cout] f32 = the conv of x [N,H,W,cin] (T) with the weights
// [taps][cin][cout] (T) over the ntaps (dy, dx) pairs of ``taps`` (host
// array), on the CUDA cores. T = bf16 if bf16 else f32. Returns
// cudaGetLastError() after the launch (0 on success).
int masked_conv_fwd(const void* x, const void* w, void* out, const int* taps,
                    int ntaps, int n_images, int H, int W, int cin, int cout,
                    int kh, int kw, int tr, int bf16, int mma, int threads,
                    void* stream) {
  ConvArgs a;
  int e = conv_prepare(a, x, w, out, taps, ntaps, H, W, cin, cout, kh, kw,
                       tr);
  if (e) return e;
  if (mma) return (int)cudaErrorInvalidValue;   // the tensor-core path is
                                                // masked_conv_fwd_wgmma
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? conv_launch(conv_fma_kernel<__nv_bfloat16, __nv_bfloat16,
                                            float>,
                            a, n_images, kw, 0, threads, s)
              : conv_launch(conv_fma_kernel<float, float, float>, a,
                            n_images, kw, 0, threads, s);
}

// The same conv on the tensor cores: x bf16 (16-byte aligned), W in
// {16, 32, 64, 128}, cin % 16 == 0, cout <= npad, npad one of 32, 64, 128,
// 160, 256, the weights packed as conv_wgmma_kernel reads them with their
// columns zero-padded to npad; ``limit``: dynamic shared memory allowed.
int masked_conv_fwd_wgmma(const void* x, const void* w, void* out,
                          const int* taps, int ntaps, int n_images, int H,
                          int W, int cin, int cout, int npad, int kh, int kw,
                          size_t limit, void* stream) {
  if (W < 16 || W % 16 || WG_TILE_SEGS % (W / 16) || cin % 16 || cout % 2 ||
      cout > npad || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  int e = conv_prepare(a, x, w, out, taps, ntaps, H, W, cin, cout, kh, kw,
                       WG_TILE_SEGS / (W / 16));
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (npad) {
    case 32: return wgmma_launch<32>(a, n_images, kw, limit, s);
    case 64: return wgmma_launch<64>(a, n_images, kw, limit, s);
    case 128: return wgmma_launch<128>(a, n_images, kw, limit, s);
    case 160: return wgmma_launch<160>(a, n_images, kw, limit, s);
    case 256: return wgmma_launch<256>(a, n_images, kw, limit, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
