// Patch-embed tokenizer for Hopper (sm_90a): a stride == kernel Conv3d
// computed as one implicit-im2col GEMM.
//
// Replaces the TPU kernel focus_tpu/ops/pallas/patch_embed.py
// (_patch_kernel, called through _fwd_pallas / patch_embed_3d).
//
// out[m, n] = bias[n] + sum_k patch[m, k] * w[k, n], where row m is one
// (b, t', h', w') patch and column k = (i_t, i_h, i_w, c) walks the patch in
// the JAX kernel layout [kt, kh, kw, C]. Each block gathers its patch rows
// straight from the [B, T, H, W, C] video (no patch tensor is ever
// materialised; a run of kw * C values is contiguous in memory), converts
// them to bf16, and multiplies against the [K, D] bf16 weight on the tensor
// cores (WMMA 16x16x16, float accumulation); the bias is added in the
// epilogue. Any C works: nothing is padded.
//
// Bound on this card: at the flagship shape (M = 12544, K = 1536, D = 768)
// the product is 29.6 GFLOP (0.030 ms at the bf16 peak) against ~99 MB of
// traffic with a float32 video (0.029 ms at the memory rate): the two bounds
// nearly meet. This first version is a plain shared-memory tiled GEMM
// without a multi-stage copy pipeline; TMA/wgmma staging is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 128;   // 4 warps in a 2 x 2 grid of 32 x 32 tiles
constexpr int LDA = BK + 8;    // bf16 row strides (multiples of 16 bytes)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;    // float staging stride

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename Tin>
__global__ void __launch_bounds__(THREADS) patch_embed_kernel(
    const Tin* __restrict__ x, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, bf16* __restrict__ out,
    int T, int H, int W, int C, int kt, int kh, int kw,
    int tp, int hp, int wp, int M, int K, int D) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ long long row_base[BM];
  __shared__ int col_off[BK];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int run = kw * C;  // contiguous values per (i_t, i_h)

  for (int r = tid; r < BM; r += THREADS) {
    const int m = m0 + r;
    long long base = -1;
    if (m < M) {
      int rest = m;
      const int wi = rest % wp; rest /= wp;
      const int hi = rest % hp; rest /= hp;
      const int ti = rest % tp;
      const int b = rest / tp;
      base = ((((long long)b * T + (long long)ti * kt) * H +
               (long long)hi * kh) * W + (long long)wi * kw) * C;
    }
    row_base[r] = base;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous tiles are consumed
    for (int c = tid; c < BK; c += THREADS) {
      const int k = k0 + c;
      int off = -1;
      if (k < K) {
        const int q = k / run, rem = k % run;
        off = ((q / kh) * H + (q % kh)) * W * C + rem;
      }
      col_off[c] = off;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r * LDB + c] = (k < K && n < D) ? w[(long long)k * D + n]
                                         : __float2bfloat16(0.0f);
    }
    __syncthreads();
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const long long base = row_base[r];
      const int off = col_off[c];
      const float v = (base >= 0 && off >= 0) ? to_f32(x[base + off]) : 0.0f;
      As[r * LDA + c] = __float2bfloat16(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bm[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bm[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < D)
      out[(long long)m * D + n] =
          __float2bfloat16(Cs[r * LDC + c] + __bfloat162float(bias[n]));
  }
}

}  // namespace

// x [B, T, H, W, C] (float32 when x_is_bf16 == 0, else bf16); w [K, D] bf16
// with K = kt * kh * kw * C in [kt, kh, kw, C] order; bias [D] bf16;
// out [B, T/kt * H/kh * W/kw, D] bf16. Returns the launch's cudaError_t.
extern "C" int patch_embed_bf16(const void* x, const void* w, const void* bias,
                                void* out, int x_is_bf16, int B, int T, int H,
                                int W, int C, int kt, int kh, int kw, int D,
                                void* stream) {
  const int tp = T / kt, hp = H / kh, wp = W / kw;
  const int M = B * tp * hp * wp, K = kt * kh * kw * C;
  if (M <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((D + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    patch_embed_kernel<bf16><<<grid, THREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(bias), static_cast<bf16*>(out), T, H, W, C,
        kt, kh, kw, tp, hp, wp, M, K, D);
  } else {
    patch_embed_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(bias), static_cast<bf16*>(out), T, H, W, C,
        kt, kh, kw, tp, hp, wp, M, K, D);
  }
  return (int)cudaGetLastError();
}
