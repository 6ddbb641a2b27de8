// K1: the whole masked AR conv net of one IAF step, fused, for Hopper.
//
// Replaces iaf_tpu/ops/ar_stack.py:_stack_kernel (pallas_call at :219,
// entry ar_stack_fused :268). Computes, per image, the chain
//   h1 = ELU(conv(z, W0) + b0 + ctx)        z: cz -> ch, zero-diagonal centre
//   h_i = ELU(conv(h_{i-1}, W_i) + b_i)     ch -> ch   (depth_ar - 1 times)
//   out = conv(h_last, W_out) + b_out       ch -> cout (merged m|s heads)
// with 3x3 stride-1 SAME convs whose weights arrive folded (V/|V|*g*mask)
// and packed per live tap: a 3x3 raster AR mask leaves only the taps
// (0,0) (0,1) (0,2) (1,0) (1,1) nonzero, so each conv is a sum over those
// five taps and the four dead ones are never computed.
//
// Design. The TPU kernel kept 4 images and a [4,18,18,160] f32 scratch in
// 16 MB of VMEM. A Hopper block has 227 KB of shared memory, where one
// padded 160-wide f32 image (207 KB) fits only once. But the mask makes
// every conv causal in rows: output row y reads input rows y-1 and y only.
// So a block walks its image's rows top to bottom as a wavefront and keeps,
// for the input of every conv, a ring of just two padded rows in shared
// memory; every intermediate stays on chip and only z, ctx and the heads
// touch device memory. The context add, bias and ELU are fused into each
// conv's epilogue, which writes the row into the next ring (rounded to T
// there, as the Pallas kernel rounds at each matmul input) or, for the head
// conv, to device memory. Two paths share this structure:
//
// * bf16 with whole 16-pixel rows and 16-deep channel steps (the paper
//   config): ar_stack_mma_kernel, tensor cores through mma.sync m16n8k16
//   (bf16 in, f32 accumulate). MMA_IMAGES = 2 images per block share every
//   weight fragment, which halves the weight traffic through L2.
// * anything else, and f32 (whose tolerance TF32 would break):
//   ar_stack_kernel, FP32 FMA on the CUDA cores, one thread per output
//   channel of PX neighbouring pixels, activations broadcast from shared
//   memory, weights coalesced across output channels from L1/L2.
//
// Bound on the H100 at the eval shape (N=1024 images of 16x16, cz=32,
// ch=160, cout=64): 107.4 GFLOP over the live taps against ~252 MB of
// compulsory traffic in bf16 (~270 MB in f32), i.e. ~109 us at the bf16
// tensor-core peak vs ~75 us of HBM time: bound by operations. The mma.sync
// path reaches about an eleventh of that bound. Cutting the weight traffic
// through L2 (tried at up to 8 images per block) or widening the weight
// loads did not move its time; what did was keeping more warps resident
// (two blocks per SM). Staging each tap's weights in shared memory, wgmma
// with asynchronous accumulators, and one barrier per row are the next
// things to try. The FMA path's floor is 107.4 GFLOP at 67 TFLOP/s, ~1.6 ms.
//
// Types: T = float or __nv_bfloat16 for z, weights and the on-chip
// activations; ctx, biases, accumulation and the output are f32.

#include "common.cuh"

// Convs in one chain: the kernel arguments carry one weight, bias and
// pre-activation pointer per conv. Shared memory binds first: at the paper
// widths (W=16, cz=32, ch=160) a block holds 7 convs on the f32 FMA path,
// 14 on the bf16 one and 10 on the tensor-core path (ar_stack_smem_bytes).
#define MAX_CONVS 32
#define NTAPS 5
#define PX 8  // output pixels per thread item

struct StackArgs {
  const void* z;              // [N,H,W,cz] T
  const float* ctx;           // [N,H,W,ch] f32
  const void* w[MAX_CONVS];   // [NTAPS, cin_i, cout_i] T
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
// Sum of the input widths of convs 0..i-1, each widened by pad: where conv
// i's ring starts, in (padded) channels per ring column.
__host__ __device__ static inline size_t chans_before(int i, int cz, int ch,
                                                      int pad) {
  return i == 0 ? 0 : (size_t)(cz + pad) + (size_t)(i - 1) * (ch + pad);
}

__host__ __device__ static inline int ring_width(int W) { return W + 2 + PX; }

// Shared memory: for conv i, two padded rows [2][W+2+PX][cin_i] of T.
static size_t smem_bytes(int n_convs, int W, int cz, int ch, size_t elem) {
  return (size_t)2 * ring_width(W) * chans_before(n_convs, cz, ch, 0) * elem;
}

template <typename T>
__global__ void ar_stack_kernel(StackArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x;
  const int H = a.H, W = a.W, RW = ring_width(W);
  // conv i's ring: [2][RW][cin_i] of T, after the rings of convs 0..i-1
  T* const rings = reinterpret_cast<T*>(smem);
  auto ring = [&](int i) {
    return rings + (size_t)2 * RW * chans_before(i, a.cz, a.ch, 0);
  };
  // Zero once: the padding columns and the row above the image stay zero.
  const size_t off = (size_t)2 * RW * chans_before(a.n_convs, a.cz, a.ch, 0) *
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

// ---------------------------------------------------------------------------
// Tensor-core path (bf16): the same row wavefront, but each conv row is a
// [W pixels x cout] tile computed with mma.sync m16n8k16 (bf16 in, f32
// accumulate). A fragments (16 pixels x 16 channels of one tap) come from
// the shared-memory rings, whose channel stride is padded by CPAD so the
// 8 pixel rows of a fragment fall in distinct banks. B fragments (16
// channels x 8 outputs) come from weights the wrapper packs in fragment
// order, [tap][n-tile][k-step][lane][2 x bf16x2], so a warp reads one
// 256-byte run per fragment with one 8-byte load per lane. One block holds
// R = MMA_IMAGES images and every B fragment feeds all R of them (1 and 4
// images per block were measured too: 1 is slower, 4 no faster and it
// spills registers under the two-blocks-per-SM cap). Each warp owns pairs
// of 8-wide output tiles; KU k-steps of B fragments are loaded before the
// first is used.
// ---------------------------------------------------------------------------

#define CPAD 8
#define KU 4
#define MMA_IMAGES 2

// Padded ring row of the tensor-core path: pixel x at column x+1.
__host__ __device__ static inline int mma_ring_width(int W) { return W + 2; }

// bf16 elements of one image's rings: for conv i, [2][W+2][cin_i + CPAD].
__host__ __device__ static inline size_t mma_image_elems(int n_convs, int W,
                                                         int cz, int ch) {
  return (size_t)2 * mma_ring_width(W) * chans_before(n_convs, cz, ch, CPAD);
}

static size_t mma_smem_bytes(int n_convs, int W, int cz, int ch) {
  return mma_image_elems(n_convs, W, cz, ch) * 2 * MMA_IMAGES;
}

// Two blocks per SM: at 320 threads the registers are capped so that two
// blocks fit on an SM; what bounds this kernel is how many warps are
// resident, not how many bytes it moves.
__global__ void __launch_bounds__(320, 2)
    ar_stack_mma_kernel(StackArgs a, int n_images) {
  constexpr int R = MMA_IMAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, W = a.W, RW = mma_ring_width(W);
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  // image r's rings follow those of images 0..r-1; within an image, conv
  // i's ring [2][RW][cin_i + CPAD] follows those of convs 0..i-1
  const size_t per_image = mma_image_elems(a.n_convs, W, a.cz, a.ch);
  __nv_bfloat16* const rings = reinterpret_cast<__nv_bfloat16*>(smem);
  auto ring = [&](int r, int i) {
    return rings + r * per_image +
           (size_t)2 * RW * chans_before(i, a.cz, a.ch, CPAD);
  };
  const size_t off = per_image * R * 2;
  uint32_t* s32 = reinterpret_cast<uint32_t*>(smem);
  for (size_t i = threadIdx.x; i < off / 4; i += blockDim.x) s32[i] = 0u;
  __syncthreads();

  const int img0 = blockIdx.x * R;
  const __nv_bfloat16* z = static_cast<const __nv_bfloat16*>(a.z);
  const int zrow = W * a.cz;

  for (int y = 0; y < H; ++y) {
    const int s = y & 1, p = s ^ 1;
    for (int idx = threadIdx.x; idx < R * zrow; idx += blockDim.x) {
      const int r = idx / zrow, rem = idx - r * zrow;
      const int x = rem / a.cz, c = rem - x * a.cz;
      const int img = img0 + r;
      ring(r, 0)[((size_t)s * RW + x + 1) * (a.cz + CPAD) + c] =
          img < n_images ? z[((size_t)img * H + y) * zrow + rem]
                         : __float2bfloat16(0.f);
    }
    __syncthreads();

    for (int c = 0; c < a.n_convs; ++c) {
      const int ci_n = conv_cin(a, c), co_n = conv_cout(a, c);
      const int ntiles = co_n / 8, ksteps = ci_n / 16, csc = ci_n + CPAD;
      const uint2* __restrict__ wf = static_cast<const uint2*>(a.w[c]);
      const float* __restrict__ bias = a.b[c];
      const bool last = (c == a.n_convs - 1);
      const __nv_bfloat16* src[R];
#pragma unroll
      for (int r = 0; r < R; ++r) src[r] = ring(r, c);
      for (int pair = warp; pair * 2 < ntiles; pair += nwarps) {
        const bool has1 = pair * 2 + 1 < ntiles;
        for (int x0 = 0; x0 < W; x0 += 16) {
          float acc[2][R][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[j][r][q] = 0.f;
#pragma unroll
          for (int t = 0; t < NTAPS; ++t) {
            const int slot = t < 3 ? p : s;
            const int dx = t < 3 ? t : t - 3;
            const uint2* w0 =
                wf + ((size_t)(t * ntiles + pair * 2) * ksteps) * 32 + lane;
            const uint2* w1 = w0 + (size_t)ksteps * 32;
            const int abase = (slot * RW + x0 + g + dx) * csc + 2 * tig;
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
                const int k0 = (kb + u) * 16;
#pragma unroll
                for (int r = 0; r < R; ++r) {
                  const __nv_bfloat16* ab = src[r] + abase + k0;
                  uint32_t af[4];
                  af[0] = lds32(ab);
                  af[1] = lds32(ab + 8 * csc);
                  af[2] = lds32(ab + 8);
                  af[3] = lds32(ab + 8 * csc + 8);
                  mma_16816(acc[0][r], af, b0[u].x, b0[u].y);
                  if (has1) mma_16816(acc[1][r], af, b1[u].x, b1[u].y);
                }
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j == 1 && !has1) break;
            const int co = (pair * 2 + j) * 8 + 2 * tig;
            const float bv0 = bias[co], bv1 = bias[co + 1];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const int img = img0 + r;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int x = x0 + g + half * 8;
                float v0 = acc[j][r][2 * half] + bv0;
                float v1 = acc[j][r][2 * half + 1] + bv1;
                const size_t pix = ((size_t)img * H + y) * W + x;
                if (c == 0 && img < n_images) {
                  const float2 cv =
                      *reinterpret_cast<const float2*>(a.ctx + pix * a.ch + co);
                  v0 += cv.x;
                  v1 += cv.y;
                }
                if (last) {
                  if (img < n_images)
                    *reinterpret_cast<float2*>(a.out + pix * a.cout + co) =
                        make_float2(v0, v1);
                } else {
                  if (a.pre[c] != nullptr && img < n_images)
                    *reinterpret_cast<float2*>(a.pre[c] + pix * a.ch + co) =
                        make_float2(v0, v1);
                  v0 = elu(v0);
                  v1 = elu(v1);
                  *reinterpret_cast<__nv_bfloat162*>(
                      ring(r, c + 1) +
                      ((size_t)s * RW + x + 1) * (a.ch + CPAD) + co) =
                      __floats2bfloat162_rn(v0, v1);
                }
              }
            }
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

static int launch_mma(const StackArgs& a, int n_images, int threads,
                      cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(a.n_convs, a.W, a.cz, a.ch);
  cudaError_t e = cudaFuncSetAttribute(
      ar_stack_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n_images + MMA_IMAGES - 1) / MMA_IMAGES;
  ar_stack_mma_kernel<<<blocks, threads, smem, stream>>>(a, n_images);
  return (int)cudaGetLastError();
}

extern "C" {

// Bytes of dynamic shared memory one block asks for (the wrapper checks it
// against the 227 KB a Hopper block may use). mma = 0 selects the FMA
// path, 1 the tensor-core path.
size_t ar_stack_smem_bytes(int n_convs, int W, int cz, int ch, int bf16,
                           int mma) {
  if (mma) return mma_smem_bytes(n_convs, W, cz, ch);
  return smem_bytes(n_convs, W, cz, ch, bf16 ? 2 : 4);
}

// Returns cudaGetLastError() after the launch (0 on success). w and b are
// host arrays of n_convs device pointers (packed weights, biases); pre is
// null or a host array of n_convs - 1 device pointers, each null or where
// that hidden conv's f32 pre-activation goes.
int ar_stack_fwd(const void* z, const void* ctx, const void* const* w,
                 const void* const* b, void* out, void* const* pre,
                 int n_convs, int n_images, int H, int W, int cz, int ch,
                 int cout, int bf16, int mma, int threads, void* stream) {
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
  if (mma) {
    if (!bf16 || W % 16 || cz % 16 || ch % 16 || cout % 8)
      return (int)cudaErrorInvalidValue;
    return launch_mma(a, n_images, threads, s);
  }
  return bf16 ? launch<__nv_bfloat16>(a, n_images, threads, s)
              : launch<float>(a, n_images, threads, s);
}

}  // extern "C"
