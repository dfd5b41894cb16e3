// Backward of the fused trajectory-attention core for Hopper (sm_90a).
//
// Replaces the TPU kernel focus_tpu/ops/pallas/trajectory_block.py
// (_fused_bwd_kernel, called through _fused_bwd_pallas / _fused_bwd). It
// computes the gradients that jax.vjp of _xla_reference gives for q, kf, vf,
// Wq2, bq2 and Wk2 (the k2 bias has none), from the forward's inputs, the
// output gradient dout, and two residuals the forward kernel already writes
// to device memory: the stage-1 aggregates xs [B, S, F, C] and q2 [B, S, C].
//
// Stage 2 follows the TPU kernel's g-form. Per row m and head h,
// g_h = q2_h . Wk2_h^T (K = 64), the logits l2[h, f] = scale g_h . xs_f,
// a2 = softmax_f(l2), da2 = dout_h . xs_f,h, dl2 = scale a2 (da2 - sum_f a2
// da2) and dg_h = sum_f dl2 xs_f; then
//   dq2_h = dg_h . Wk2_h,  dWk2[:, h] = sum_m dg_h^T q2_h,
//   dWq2  = x_diag^T dq2,  dbq2 = sum_m dq2,  dd = dq2 . Wq2^T,
//   dxs_f = sum_h dl2[h, f] g_h + a2[h(c), f] dout + [f == own frame] dd.
// Nothing of size [B S F, C] but xs and dxs exists: g and dg live in
// registers and shared memory. dq2 reduces over the columns of C and dWk2
// over the rows, and the register file holds one of the two accumulators
// for a block's rows (dq2: 32 rows x C) or columns (dWk2: 32 columns x C),
// not both, so dg is formed twice, once row-owned and once column-owned.
// Operations stage 2 issues at M = B S rows (B = 8, S = 1568, F = 8,
// C = 768, 12 heads): six C x C products on the tensor cores, 2 M C^2 each
// (g twice, dq2, dWk2, dWq2, dd: 88.8 GFLOP), and on the CUDA cores the
// logits, dg twice and the dxs logit term, 2 M F C heads each (7.4 GFLOP),
// and da2 (0.15): ~96 GFLOP in all, against ~385 in the first design's
// Y = xs . Wk2 form. xs is read three times: by the logits-and-dq2 kernel
// (two passes over a block's columns, which do not fit shared memory
// together) and by the dWk2 kernel.
//
// Stage 1 follows the FlashAttention-2 backward on wgmma and TMA (the
// machinery of trajectory_attention.cu: a producer warpgroup issuing TMA
// copies into a ring of mbarrier-guarded slots, two consumer warpgroups at
// wgmma, setmaxnreg moving registers from the producer to the consumers).
// The dq kernel takes 128 queries of a (batch row, head) and streams the F
// frames' K, V and dO tiles: the logits S = Q K_f^T (m64 x NP keys, NP the
// frame's keys padded to an instantiated width), the true max-subtracted
// softmax P in float32 registers, dP = dO V_f^T beside it (208 registers at
// NP = 208; dq's accumulators wait in shared memory meanwhile), r = sum_n
// P dP, dS = P (dP - r) and dq += dS K_f. It writes the row statistics
// (log2-sum-exp and r). At 256 < N <= 512 (the 336 crop's 441 and 445) a
// frame's keys go in two chunks of 224 or 256 (stage1_dq_chunked_kernel):
// a first sweep over the chunks carries the max, the softmax's sum and r
// online, a second forms P, dS and dq; one launch as at N <= 256, whose
// forms are unchanged. The dk/dv kernel takes 128 keys of all frames
// together (F N = 1568 rows at N = 196, not a frame padded to 256 rows),
// streams the queries in chunks of 64 with the statistics of every frame,
// and lets each key row read its own frame's: S^T = K Q^T, dP^T = V dO_f^T
// per frame present (rows of another frame discarded), P^T and dS^T,
// dv += P^T dO_f and dk += dS^T Q. The logits are formed twice (once a
// kernel) and dP twice, where the first design formed dP three times.
// r stays a dP sum: r = dxs . xs from stage 2's bf16 operands misses the
// gate on the extreme inputs (tests/test_torch_port_bwd_redesign.py).
//
// Where the time goes on an H100 (chip_smoke.py, PERF.md): the stage-2 row
// kernel is held by its register footprint (dq2's 32 x C accumulators: one
// block of 8 warps an SM, too few to hide mma.sync's latency chains) and by
// Wk2 streamed through L2 once a pass per 32 rows; the dWk2 and dxs kernels
// by the same per-tile streaming of q2 and Wk2. Stage 2 on wgmma with row
// tiles shared across a cluster is the next design.
//
// Rounding points: g, l2, a2, dl2, dq2 (float32 copy), dd, P, r, dS and every
// accumulator stay in float32; dg, dq2 (GEMM copy), dxs and the stage-1
// weights P for dv are rounded to bf16 as tensor-core operands; dS enters
// dq and dk as a pair of bf16 values (its rounding and the rest), because
// dq = sum_n dS k_n cancels (sum_n dS = 0), which bf16 dS would swamp. No
// atomics: every cross-block sum (dWq2, dWk2 and dbq2 partials) is a second
// pass in a fixed order, so two calls give the same bits.
//
// Launches, all on the caller's stream behind one C call: the stage-2 row
// kernel (logits, a2, dl2, dq2, dbq2 partials); dd = dq2 . Wq2^T; the dWq2
// split-K GEMM; the dWk2 kernel; the dxs kernel; one fixed-order sum of the
// three partial sets; the stage-1 dq kernel; the stage-1 dk/dv kernel. 8 in
// all, counted into *launched.
//
// Bound on this card at B = 8, S = 1568, N = 196: ~231 GFLOP in the TPU
// kernel's form (five stage-1 products of 2 B S F N C, five C x C products,
// three stage-2 contractions) against ~0.3 GB of inputs and outputs: bound
// by operations (0.23 ms at the bf16 peak).

#include <type_traits>

#include "hopper_async.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int HD = 64;           // head dim
constexpr int MAX_F = 8;
constexpr int MAX_HEADS = 16;
constexpr int SPLITS = 16;       // split-K depth of dWq2
constexpr int W_SPLITS = 5;      // row splits of dWk2
constexpr int SMEM_LIMIT = 232448;

thread_local int launches = 0;   // device kernels of the current call

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// x = hi + lo with both bf16: hi its rounding, lo the rounding of the rest
// (~2^-17 relative together), packed in pairs as mma operands
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(a - hf.x, b - hf.y);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a row's F <= 8 statistics of one head from shared memory (16-byte aligned
// when F % 4 == 0), zero past F
__device__ __forceinline__ void load_row_stats(const float* p, int F,
                                               float (&d)[MAX_F]) {
  if (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < MAX_F / 4; ++q) {
      const float4 v = q * 4 < F ? reinterpret_cast<const float4*>(p)[q]
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      d[4 * q] = v.x;
      d[4 * q + 1] = v.y;
      d[4 * q + 2] = v.z;
      d[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < MAX_F; ++f) d[f] = f < F ? p[f] : 0.0f;
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---- a tiled bf16 GEMM with float32 accumulation -------------------------
// C[M, N] = op(A)[M, K] . op(B)[K, N] over one K chunk per blockIdx.z. A is
// stored [M][K] (row stride lda) or, with AT, [K][M], where stored row k can
// be gathered as the own-frame row of xs; B is stored [K][N] or, with BT,
// [N][K]. 128 x 128 output tiles, 8 warps of 64 x 32, k-steps of 32 copied
// in (cp.async) one step ahead of use. K and the chunk are multiples of 8.

constexpr int GM = 128, GN = 128, GK = 32, G_THREADS = 256;
constexpr int LD_K = GK + 8;     // tiles stored [row][k]
constexpr int LD_MN = GM + 8;    // tiles stored [k][row]
constexpr int TILE = GM * LD_K;  // >= GK * LD_MN

struct GemmArgs {
  const bf16* a;
  const bf16* b;
  int M, N, K, lda, ldb;
  int k_chunk;                  // K per blockIdx.z, a multiple of GK
  int gather, S, Nk, F;         // AT: stored row k at (k F + (k % S) / Nk) lda
  float* out;                   // out[z * out_z + row * N + col]
  size_t out_z;
};

template <bool AT, bool BT>
__global__ void __launch_bounds__(G_THREADS) gemm_kernel(const GemmArgs p) {
  __shared__ __align__(128) bf16 As[2][TILE];
  __shared__ __align__(128) bf16 Bs[2][TILE];
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;  // warp tile rows wm*64, cols wn*32

  auto a_row = [&](int r) -> const bf16* {
    if (AT && p.gather)
      return p.a + ((size_t)r * p.F + (r % p.S) / p.Nk) * p.lda;
    return p.a + (size_t)r * p.lda;
  };
  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * G_THREADS;
      if (!AT) {  // [128 m][32 k]
        const int r = i >> 2, c8 = (i & 3) * 8;
        bf16* dst = As[stage] + r * LD_K + c8;
        if (m0 + r < p.M && k0 + c8 < kend)
          cp_async16(dst, a_row(m0 + r) + k0 + c8);
        else
          zero16(dst);
      } else {    // [32 k][128 m]
        const int r = i >> 4, c8 = (i & 15) * 8;
        bf16* dst = As[stage] + r * LD_MN + c8;
        if (k0 + r < kend && m0 + c8 < p.M)
          cp_async16(dst, a_row(k0 + r) + m0 + c8);
        else
          zero16(dst);
      }
      if (!BT) {  // [32 k][128 n]
        const int r = i >> 4, c8 = (i & 15) * 8;
        bf16* dst = Bs[stage] + r * LD_MN + c8;
        if (k0 + r < kend && n0 + c8 < p.N)
          cp_async16(dst, p.b + (size_t)(k0 + r) * p.ldb + n0 + c8);
        else
          zero16(dst);
      } else {    // [128 n][32 k]
        const int r = i >> 2, c8 = (i & 3) * 8;
        bf16* dst = Bs[stage] + r * LD_K + c8;
        if (n0 + r < p.N && k0 + c8 < kend)
          cp_async16(dst, p.b + (size_t)(n0 + r) * p.ldb + k0 + c8);
        else
          zero16(dst);
      }
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nk = kend > kbeg ? (kend - kbeg + GK - 1) / GK : 0;
  if (nk > 0) load_tile(0, kbeg);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile((kt + 1) & 1, kbeg + (kt + 1) * GK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* At = As[kt & 1];
    const bf16* Bt = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!AT)
          ldmatrix_x4(af[i], At + (wm * 64 + i * 16 + (lane & 7) +
                                   8 * ((lane >> 3) & 1)) * LD_K +
                                 kk * 16 + 8 * (lane >> 4));
        else
          ldmatrix_x4_trans(af[i], At + (kk * 16 + (lane & 7) + 8 * (lane >> 4)) *
                                            LD_MN + wm * 64 + i * 16 +
                                        8 * ((lane >> 3) & 1));
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r4[4];
        if (!BT)
          ldmatrix_x4_trans(r4, Bt + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                         LD_MN + wn * 32 + jp * 16 + 8 * (lane >> 4));
        else
          ldmatrix_x4(r4, Bt + (wn * 32 + jp * 16 + (lane & 7) + 8 * (lane >> 4)) *
                                   LD_K + kk * 16 + 8 * ((lane >> 3) & 1));
        bfr[2 * jp][0] = r4[0];
        bfr[2 * jp][1] = r4[1];
        bfr[2 * jp + 1][0] = r4[2];
        bfr[2 * jp + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t;
      if (col >= p.N) continue;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = m0 + wm * 64 + i * 16 + g + 8 * hi;
        if (row >= p.M) continue;
        *reinterpret_cast<float2*>(p.out + blockIdx.z * p.out_z +
                                   (size_t)row * p.N + col) =
            make_float2(acc[i][j][2 * hi], acc[i][j][2 * hi + 1]);
      }
    }
  }
}

template <bool AT, bool BT>
cudaError_t gemm(const GemmArgs& p, int splits, cudaStream_t st) {
  const dim3 grid((p.N + GN - 1) / GN, (p.M + GM - 1) / GM, splits);
  gemm_kernel<AT, BT><<<grid, G_THREADS, 0, st>>>(p);
  ++launches;
  return cudaGetLastError();
}

// split-K chunk: ceil(K / SPLITS) rounded up to GK
inline int split_chunk(int K) {
  return (int)round_up((size_t)(K + SPLITS - 1) / SPLITS, GK);
}

// out[i] = sum_z part[z * n + i] in a fixed order (n % 4 == 0), one job a
// blockIdx.y
struct SumJob {
  const float* part;
  float* out;
  int n, splits;
};
struct SumJobs {
  SumJob job[3];
};

__global__ void __launch_bounds__(256) sum_splits_kernel(const SumJobs jobs) {
  const SumJob j = jobs.job[blockIdx.y];
  if (j.splits > 64) {
    // many splits, few columns: the 8 warps of a block take 32 columns and
    // contiguous eighths of the splits, then add their sums in warp order
    __shared__ float part[8][32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int per = (j.splits + 7) / 8;
    const int z0 = warp * per, z1 = min(j.splits, z0 + per);
    for (int c0 = blockIdx.x * 32; c0 < j.n; c0 += gridDim.x * 32) {
      const int c = c0 + lane;
      float s = 0.0f;
      if (c < j.n) {
#pragma unroll 8
        for (int z = z0; z < z1; ++z) s += j.part[(size_t)z * j.n + c];
      }
      part[warp][lane] = s;
      __syncthreads();
      if (warp == 0 && c < j.n) {
        float t = 0.0f;
        for (int w = 0; w < 8; ++w) t += part[w][lane];
        j.out[c] = t;
      }
      __syncthreads();
    }
    return;
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < j.n / 4;
       i += gridDim.x * blockDim.x) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int z = 0; z < j.splits; ++z) {
      const float4 v = reinterpret_cast<const float4*>(j.part + (size_t)z * j.n)[i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(j.out)[i] = s;
  }
}

// ---- stage 2 ---------------------------------------------------------------
// Rows m = b * S + s. Tiles of 32 rows or columns, 8 warps, mma.sync
// m16n8k16 (bf16 in, float32 accumulate), operands copied into padded
// shared memory by cp.async one slice ahead of use.

constexpr int S2_RT = 32;        // rows (or columns) a block or slice
constexpr int S2_CW = 32;        // columns of C a slice
constexpr int S2_THREADS = 256;

// bf16 row strides: q2 and Wk2 rows (C + 8), xs rows of a slice (F x 32 + 8);
// float32 rows of the per-row statistics [heads x F]: 4 words past a multiple
// of 8, so that the 8 rows a warp's lanes read fall in 8 different banks
__host__ __device__ inline int s2_lq(int C) { return C + 8; }
__host__ __device__ inline int s2_lx(int F) { return F * S2_CW + 8; }
__host__ __device__ inline int s2_lhf(int HF) { return (HF + 7) / 8 * 8 + 4; }

constexpr int S2_LD = S2_CW + 8;   // bf16 rows of a slice of dout
constexpr int S2_LF = S2_CW + 4;   // float32 rows of a slice of dd

size_t rows_smem(int C, int F, int heads) {
  return (size_t)(S2_RT * s2_lq(C) + 2 * S2_RT * s2_lx(F) +
                  2 * S2_CW * s2_lq(C)) * sizeof(bf16) +
         (size_t)2 * S2_RT * s2_lhf(heads * F) * sizeof(float) +
         (size_t)2 * S2_RT * S2_LD * sizeof(bf16);
}

// The stage-2 row kernel: one block per 32 rows; warp w holds rows
// 16 (w & 1) and the heads h = (w >> 1) + 4 i. Pass 1 over the column
// slices of C: g_h for the slice (K = 64 from the q2 tile) dotted with the
// slice of xs_f gives the logits' partial sums, and the slice of head h's
// own columns gives da2; then a2 and dl2 (also written out, [M, heads, F]).
// Pass 2 over the slices again: dg_h for the slice (rounded to bf16, an A
// fragment) times Wk2's rows of the slice accumulates dq2_h in registers.
// Writes dq2 (float32 and bf16) and per-warp column sums of dq2 (the dbq2
// partials, [2 * blocks, C]).
template <int HPW>
__global__ void __launch_bounds__(S2_THREADS, 1) stage2_rows_kernel(
    const bf16* __restrict__ xs, const bf16* __restrict__ q2,
    const bf16* __restrict__ dout, const bf16* __restrict__ wk2,
    float* __restrict__ a2o, float* __restrict__ dl2o,
    float* __restrict__ dq2, bf16* __restrict__ dq2b,
    float* __restrict__ bpart, int M, int F, int C, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LQ = s2_lq(C), LX = s2_lx(F), HF = heads * F, LH = s2_lhf(HF);
  bf16* Q2s = reinterpret_cast<bf16*>(smem);           // [RT][LQ]
  bf16* XS = Q2s + S2_RT * LQ;                          // [2][RT][LX]
  bf16* WB = XS + 2 * S2_RT * LX;                       // [2][CW][LQ]
  float* L2S = reinterpret_cast<float*>(WB + 2 * S2_CW * LQ);  // [RT][LH]
  float* D2S = L2S + S2_RT * LH;                        // [RT][LH]
  bf16* DOS = reinterpret_cast<bf16*>(D2S + S2_RT * LH);  // [2][RT][LD]

  const int m0 = blockIdx.x * S2_RT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 1, hq = warp >> 1;
  const int rA = rg * 16 + g, rB = rA + 8;   // this thread's local rows
  const int ncs = C / S2_CW;
  const int c8n = C / 8;

  for (int i = tid; i < S2_RT * c8n; i += S2_THREADS) {
    const int r = i / c8n, c8 = (i % c8n) * 8;
    bf16* dst = Q2s + r * LQ + c8;
    if (m0 + r < M) cp_async16(dst, q2 + (size_t)(m0 + r) * C + c8);
    else zero16(dst);
  }
  cp_async_commit();

  auto load_cs = [&](int cs, int buf) {
    bf16* xd = XS + buf * S2_RT * LX;
    for (int i = tid; i < S2_RT * F * 4; i += S2_THREADS) {
      const int r = i / (F * 4), f = (i >> 2) % F, c8 = (i & 3) * 8;
      bf16* dst = xd + r * LX + f * S2_CW + c8;
      if (m0 + r < M)
        cp_async16(dst, xs + ((size_t)(m0 + r) * F + f) * C + cs * S2_CW + c8);
      else
        zero16(dst);
    }
    bf16* wd = WB + buf * S2_CW * LQ;
    for (int i = tid; i < S2_CW * c8n; i += S2_THREADS) {
      const int r = i / c8n, c8 = (i % c8n) * 8;
      cp_async16(wd + r * LQ + c8, wk2 + (size_t)(cs * S2_CW + r) * C + c8);
    }
    for (int i = tid; i < S2_RT * (S2_CW / 8); i += S2_THREADS) {
      const int r = i / (S2_CW / 8), c8 = (i % (S2_CW / 8)) * 8;
      bf16* dst = DOS + (buf * S2_RT + r) * S2_LD + c8;
      if (m0 + r < M) cp_async16(dst, dout + (size_t)(m0 + r) * C + cs * S2_CW + c8);
      else zero16(dst);
    }
    cp_async_commit();
  };

  // a pass over the column slices of C: slice cs + 1 is copied in while
  // slice cs is used; a slice's buffers are refilled two slices on
  auto next_slice = [&](int cs) {
    if (cs + 1 < ncs) {
      load_cs(cs + 1, (cs + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };

  {  // pass 1: the logits and da2, per-thread partial sums over the slices
    // l2p: the logits of the warp's heads; d2p: da2 of the head whose
    // columns the slice holds (two consecutive slices), if it is the warp's
    float l2p[HPW][MAX_F][2], d2p[MAX_F][2];
#pragma unroll
    for (int f = 0; f < MAX_F; ++f) {
#pragma unroll
      for (int i = 0; i < HPW; ++i) l2p[i][f][0] = l2p[i][f][1] = 0.0f;
      d2p[f][0] = d2p[f][1] = 0.0f;
    }
    load_cs(0, 0);
    for (int cs = 0; cs < ncs; ++cs) {
      next_slice(cs);
      const bf16* X = XS + (cs & 1) * S2_RT * LX;
      const bf16* W = WB + (cs & 1) * S2_CW * LQ;
      // g_h[16 rows x 32 columns of the slice] for each of the warp's heads
      float gacc[HPW][4][4];
#pragma unroll
      for (int hi = 0; hi < HPW; ++hi) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[hi][j][e] = 0.0f;
        const int h = hq + 4 * hi;
        if (h >= heads) continue;
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, Q2s + (rg * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LQ +
                             h * HD + ks * 16 + 8 * (lane >> 4));
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t b[4];
            ldmatrix_x4(b, W + (jp * 16 + (lane & 7) + 8 * (lane >> 4)) * LQ +
                               h * HD + ks * 16 + 8 * ((lane >> 3) & 1));
            mma_16816(gacc[hi][2 * jp], a, b[0], b[1]);
            mma_16816(gacc[hi][2 * jp + 1], a, b[2], b[3]);
          }
        }
      }
      // da2 = dout_h . xs_f,h over the slice for the head whose it is
      const int hc = (cs * S2_CW) / HD;
      const bool own = hc % 4 == hq;
      const bf16* DO = DOS + (cs & 1) * S2_RT * S2_LD;
      float2 da[4], db[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        da[j] = own ? ld_bf16x2(DO + rA * S2_LD + 8 * j + 2 * t) : make_float2(0.0f, 0.0f);
        db[j] = own ? ld_bf16x2(DO + rB * S2_LD + 8 * j + 2 * t) : make_float2(0.0f, 0.0f);
      }
      // the slice's part of g_h . xs_f and dout_h . xs_f, xs read once
#pragma unroll
      for (int f = 0; f < MAX_F; ++f) {
        if (f >= F) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 xa = ld_bf16x2(X + rA * LX + f * S2_CW + 8 * j + 2 * t);
          const float2 xb = ld_bf16x2(X + rB * LX + f * S2_CW + 8 * j + 2 * t);
#pragma unroll
          for (int hi = 0; hi < HPW; ++hi) {
            l2p[hi][f][0] = fmaf(gacc[hi][j][0], xa.x, fmaf(gacc[hi][j][1], xa.y, l2p[hi][f][0]));
            l2p[hi][f][1] = fmaf(gacc[hi][j][2], xb.x, fmaf(gacc[hi][j][3], xb.y, l2p[hi][f][1]));
          }
          if (own) {
            d2p[f][0] = fmaf(da[j].x, xa.x, fmaf(da[j].y, xa.y, d2p[f][0]));
            d2p[f][1] = fmaf(db[j].x, xb.x, fmaf(db[j].y, xb.y, d2p[f][1]));
          }
        }
      }
      // head hc's da2 is complete after its second slice
      if (own && (cs * S2_CW + S2_CW) % HD == 0) {
#pragma unroll
        for (int f = 0; f < MAX_F; ++f) {
          const float da2a = quad_sum(d2p[f][0]), da2b = quad_sum(d2p[f][1]);
          if (t == 0 && f < F) {
            D2S[rA * LH + hc * F + f] = da2a;
            D2S[rB * LH + hc * F + f] = da2b;
          }
          d2p[f][0] = d2p[f][1] = 0.0f;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int hi = 0; hi < HPW; ++hi) {
      const int h = hq + 4 * hi;
      if (h >= heads) continue;
#pragma unroll
      for (int f = 0; f < MAX_F; ++f) {
        if (f >= F) break;
        const float la = quad_sum(l2p[hi][f][0]), lb = quad_sum(l2p[hi][f][1]);
        if (t == 0) {
          L2S[rA * LH + h * F + f] = la;
          L2S[rB * LH + h * F + f] = lb;
        }
      }
    }
  }
  __syncthreads();
  // a2 and dl2 per (row, head), in place of the logits and da2
  for (int i = tid; i < S2_RT * heads; i += S2_THREADS) {
    const int r = i / heads, h = i % heads;
    float* l = L2S + r * LH + h * F;
    float* d = D2S + r * LH + h * F;
    float mx = -INFINITY;
    for (int f = 0; f < F; ++f) mx = fmaxf(mx, l[f] * scale);
    float sum = 0.0f;
    for (int f = 0; f < F; ++f) {
      l[f] = expf(l[f] * scale - mx);
      sum += l[f];
    }
    float r2 = 0.0f;
    for (int f = 0; f < F; ++f) {
      l[f] /= sum;
      r2 += l[f] * d[f];
    }
    for (int f = 0; f < F; ++f) {
      d[f] = scale * l[f] * (d[f] - r2);
      if (m0 + r < M) {
        const size_t o = ((size_t)(m0 + r) * heads + h) * F + f;
        a2o[o] = l[f];
        dl2o[o] = d[f];
      }
    }
  }
  __syncthreads();

  // pass 2: dg_h over each slice as A fragments (k = the slice's columns),
  // then dq2_h += dg_h . Wk2[slice, h]
  float dqacc[HPW][8][4];
#pragma unroll
  for (int i = 0; i < HPW; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqacc[i][j][e] = 0.0f;
  load_cs(0, 0);
  for (int cs = 0; cs < ncs; ++cs) {
    next_slice(cs);
    const bf16* X = XS + (cs & 1) * S2_RT * LX;
    const bf16* W = WB + (cs & 1) * S2_CW * LQ;
#pragma unroll
    for (int ks = 0; ks < S2_CW / 16; ++ks) {
      // xs at this thread's A-fragment places: rows rA, rB, columns
      // ks 16 + 2t (+1) and + 8, every frame
      uint32_t xr[MAX_F][4];
#pragma unroll
      for (int f = 0; f < MAX_F; ++f) {
        const int c = f * S2_CW + ks * 16 + 2 * t;
        const bool ok = f < F;
        xr[f][0] = ok ? *reinterpret_cast<const uint32_t*>(X + rA * LX + c) : 0u;
        xr[f][1] = ok ? *reinterpret_cast<const uint32_t*>(X + rB * LX + c) : 0u;
        xr[f][2] = ok ? *reinterpret_cast<const uint32_t*>(X + rA * LX + c + 8) : 0u;
        xr[f][3] = ok ? *reinterpret_cast<const uint32_t*>(X + rB * LX + c + 8) : 0u;
      }
#pragma unroll
      for (int hi = 0; hi < HPW; ++hi) {
        const int h = hq + 4 * hi;
        if (h >= heads) continue;
        float dla[MAX_F], dlb[MAX_F];
        load_row_stats(D2S + rA * LH + h * F, F, dla);
        load_row_stats(D2S + rB * LH + h * F, F, dlb);
        float v[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q][0] = v[q][1] = 0.0f;
#pragma unroll
        for (int f = 0; f < MAX_F; ++f) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float d = (q & 1) ? dlb[f] : dla[f];
            const float2 x = unpack_bf16x2(xr[f][q]);
            v[q][0] = fmaf(d, x.x, v[q][0]);
            v[q][1] = fmaf(d, x.y, v[q][1]);
          }
        }
        uint32_t a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] = pack_bf16x2(v[q][0], v[q][1]);
#pragma unroll
        for (int jp = 0; jp < HD / 16; ++jp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, W + (ks * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LQ +
                                   h * HD + jp * 16 + 8 * (lane >> 4));
          mma_16816(dqacc[hi][2 * jp], a, b[0], b[1]);
          mma_16816(dqacc[hi][2 * jp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // dq2 and its bf16 copy; column sums of this warp's 16 rows (rows past M
  // hold zeros: their xs and q2 were copied in as zeros)
#pragma unroll
  for (int hi = 0; hi < HPW; ++hi) {
    const int h = hq + 4 * hi;
    if (h >= heads) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = h * HD + 8 * j + 2 * t;
      const float* v = dqacc[hi][j];
      if (m0 + rA < M) {
        *reinterpret_cast<float2*>(dq2 + (size_t)(m0 + rA) * C + col) = make_float2(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(dq2b + (size_t)(m0 + rA) * C + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
      if (m0 + rB < M) {
        *reinterpret_cast<float2*>(dq2 + (size_t)(m0 + rB) * C + col) = make_float2(v[2], v[3]);
        *reinterpret_cast<__nv_bfloat162*>(dq2b + (size_t)(m0 + rB) * C + col) =
            __floats2bfloat162_rn(v[2], v[3]);
      }
      float s0 = v[0] + v[2], s1 = v[1] + v[3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0)
        *reinterpret_cast<float2*>(bpart + ((size_t)blockIdx.x * 2 + rg) * C + col) =
            make_float2(s0, s1);
    }
  }
}

// The dWk2 kernel: one block per 32 columns c of Wk2's rows and one of
// W_SPLITS row ranges; warp w accumulates dWk2[c0 + 16 (w & 1) + 0..15,
// head h] for the heads h = (w >> 1) + 4 i over the range. Per 32 rows:
// dg_h[c][row] for every head from the slice of xs and dl2, rounded to bf16
// in shared memory (all threads), then dWk2 += dg_h^T q2_h. Writes the
// partial [z, C, C].
constexpr int W_LDG = S2_CW + 8;   // dg rows [head][row][column]

size_t dwk2_smem(int C, int F, int heads) {
  return (size_t)(2 * S2_RT * s2_lx(F) + 2 * S2_RT * s2_lq(C) +
                  heads * S2_RT * W_LDG) * sizeof(bf16) +
         (size_t)2 * S2_RT * s2_lhf(heads * F) * sizeof(float);
}

template <int HPW>
__global__ void __launch_bounds__(S2_THREADS, 1) stage2_dwk2_kernel(
    const bf16* __restrict__ xs, const bf16* __restrict__ q2,
    const float* __restrict__ dl2, float* __restrict__ wpart, int M, int F,
    int C, int heads, int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LQ = s2_lq(C), LX = s2_lx(F), HF = heads * F, LH = s2_lhf(HF);
  bf16* XS = reinterpret_cast<bf16*>(smem);             // [2][RT][LX]
  bf16* Q2s = XS + 2 * S2_RT * LX;                      // [2][RT][LQ]
  bf16* DG = Q2s + 2 * S2_RT * LQ;                      // [heads][RT][LDG]
  float* DL = reinterpret_cast<float*>(DG + heads * S2_RT * W_LDG);  // [2][RT][LH]

  const int c0 = blockIdx.x * S2_CW, z = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 1, hq = warp >> 1;
  const int r_begin = z * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);
  const int nsub = r_end > r_begin ? (r_end - r_begin + S2_RT - 1) / S2_RT : 0;
  const int c8n = C / 8;

  auto load_sub = [&](int i, int buf) {
    const int r0 = r_begin + i * S2_RT;
    bf16* xd = XS + buf * S2_RT * LX;
    for (int k = tid; k < S2_RT * F * 4; k += S2_THREADS) {
      const int r = k / (F * 4), f = (k >> 2) % F, c8 = (k & 3) * 8;
      bf16* dst = xd + r * LX + f * S2_CW + c8;
      if (r0 + r < r_end)
        cp_async16(dst, xs + ((size_t)(r0 + r) * F + f) * C + c0 + c8);
      else
        zero16(dst);
    }
    bf16* qd = Q2s + buf * S2_RT * LQ;
    for (int k = tid; k < S2_RT * c8n; k += S2_THREADS) {
      const int r = k / c8n, c8 = (k % c8n) * 8;
      bf16* dst = qd + r * LQ + c8;
      if (r0 + r < r_end) cp_async16(dst, q2 + (size_t)(r0 + r) * C + c8);
      else zero16(dst);
    }
    float* dd = DL + buf * S2_RT * LH;
    if (HF % 4 == 0) {
      for (int k = tid; k < S2_RT * (HF / 4); k += S2_THREADS) {
        const int r = k / (HF / 4), c4 = (k % (HF / 4)) * 4;
        float* dst = dd + r * LH + c4;
        if (r0 + r < r_end) cp_async16(dst, dl2 + (size_t)(r0 + r) * HF + c4);
        else zero16(dst);
      }
    } else {
      for (int k = tid; k < S2_RT * HF; k += S2_THREADS)
        dd[(k / HF) * LH + k % HF] =
            r0 + k / HF < r_end ? dl2[(size_t)r0 * HF + k] : 0.0f;
    }
    cp_async_commit();
  };

  float acc[HPW][8][4];
#pragma unroll
  for (int i = 0; i < HPW; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  if (nsub > 0) load_sub(0, 0);
  for (int i = 0; i < nsub; ++i) {
    const int buf = i & 1;
    if (i + 1 < nsub) {
      load_sub(i + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* X = XS + buf * S2_RT * LX;
    const bf16* Q = Q2s + buf * S2_RT * LQ;
    const float* D = DL + buf * S2_RT * LH;
    {  // dg_h[row][c] = sum_f dl2[row, h, f] xs[row, f, c]: a thread takes
       // one row, 8 columns and half the heads, its xs held in registers
      const int r = tid & 31, cg = (tid >> 5) & 3, hh = tid >> 7;
      const int hpt = (heads + 1) / 2;
      uint32_t xv[MAX_F][4];
#pragma unroll
      for (int f = 0; f < MAX_F; ++f) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (f < F)
          u = *reinterpret_cast<const uint4*>(X + r * LX + f * S2_CW + cg * 8);
        xv[f][0] = u.x;
        xv[f][1] = u.y;
        xv[f][2] = u.z;
        xv[f][3] = u.w;
      }
      for (int h = hh * hpt; h < min(heads, hh * hpt + hpt); ++h) {
        float dl[MAX_F];
        load_row_stats(D + r * LH + h * F, F, dl);
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = 0.0f;
#pragma unroll
        for (int f = 0; f < MAX_F; ++f) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 x = unpack_bf16x2(xv[f][q]);
            v[2 * q] = fmaf(dl[f], x.x, v[2 * q]);
            v[2 * q + 1] = fmaf(dl[f], x.y, v[2 * q + 1]);
          }
        }
        *reinterpret_cast<uint4*>(DG + (h * S2_RT + r) * W_LDG + cg * 8) =
            make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                       pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
      }
    }
    __syncthreads();
#pragma unroll
    for (int hi = 0; hi < HPW; ++hi) {
      const int h = hq + 4 * hi;
      if (h >= heads) continue;
#pragma unroll
      for (int ks = 0; ks < S2_RT / 16; ++ks) {
        uint32_t a[4];  // dg_h^T: stored [k = row][m = column]
        ldmatrix_x4_trans(a, DG + (h * S2_RT + ks * 16 + (lane & 7) + 8 * (lane >> 4)) *
                                     W_LDG + mt * 16 + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int jp = 0; jp < HD / 16; ++jp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Q + (ks * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LQ +
                                   h * HD + jp * 16 + 8 * (lane >> 4));
          mma_16816(acc[hi][2 * jp], a, b[0], b[1]);
          mma_16816(acc[hi][2 * jp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // DG and this buffer are written again
  }

  float* out = wpart + (size_t)z * C * C;
#pragma unroll
  for (int hi = 0; hi < HPW; ++hi) {
    const int h = hq + 4 * hi;
    if (h >= heads) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = h * HD + 8 * j + 2 * t;
      const int row = c0 + mt * 16 + g;
      *reinterpret_cast<float2*>(out + (size_t)row * C + col) =
          make_float2(acc[hi][j][0], acc[hi][j][1]);
      *reinterpret_cast<float2*>(out + (size_t)(row + 8) * C + col) =
          make_float2(acc[hi][j][2], acc[hi][j][3]);
    }
  }
}

// The dxs kernel: one block per 32 rows; warp w owns rows 16 (w & 1) and
// the 8 columns 8 (w >> 1) of each 32-column slice of C. Per slice and head:
// g_h for the warp's columns (K = 64), accumulated into the slice of dxs_f
// for every frame with dl2[row, h, f]; then the value term a2[row, h(c), f]
// dout[row, c], dd on the row's own frame, and one rounding to bf16.
size_t dxs_smem(int C, int F, int heads) {
  return (size_t)(S2_RT * s2_lq(C) + 2 * S2_CW * s2_lq(C)) * sizeof(bf16) +
         (size_t)2 * S2_RT * s2_lhf(heads * F) * sizeof(float) +
         (size_t)2 * S2_RT * S2_LD * sizeof(bf16) +
         (size_t)2 * S2_RT * S2_LF * sizeof(float);
}

__global__ void __launch_bounds__(S2_THREADS, 1) stage2_dxs_kernel(
    const bf16* __restrict__ q2, const bf16* __restrict__ wk2,
    const bf16* __restrict__ dout, const float* __restrict__ a2,
    const float* __restrict__ dl2, const float* __restrict__ dd,
    bf16* __restrict__ dxs, int M, int S, int N, int F, int C, int heads,
    int f0) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LQ = s2_lq(C), HF = heads * F, LH = s2_lhf(HF);
  bf16* Q2s = reinterpret_cast<bf16*>(smem);            // [RT][LQ]
  bf16* WB = Q2s + S2_RT * LQ;                           // [2][CW][LQ]
  float* A2S = reinterpret_cast<float*>(WB + 2 * S2_CW * LQ);  // [RT][LH]
  float* DLS = A2S + S2_RT * LH;
  float* DDS = DLS + S2_RT * LH;                           // [2][RT][LF]
  bf16* DOS = reinterpret_cast<bf16*>(DDS + 2 * S2_RT * S2_LF);  // [2][RT][LD]

  const int m0 = blockIdx.x * S2_RT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 1, cq = warp >> 1;
  const int rA = rg * 16 + g, rB = rA + 8;
  const int ncs = C / S2_CW;
  const int c8n = C / 8;

  for (int i = tid; i < S2_RT * c8n; i += S2_THREADS) {
    const int r = i / c8n, c8 = (i % c8n) * 8;
    bf16* dst = Q2s + r * LQ + c8;
    if (m0 + r < M) cp_async16(dst, q2 + (size_t)(m0 + r) * C + c8);
    else zero16(dst);
  }
  cp_async_commit();
  for (int i = tid; i < S2_RT * HF; i += S2_THREADS) {
    const bool ok = m0 + i / HF < M;
    const int o = (i / HF) * LH + i % HF;
    A2S[o] = ok ? a2[(size_t)m0 * HF + i] : 0.0f;
    DLS[o] = ok ? dl2[(size_t)m0 * HF + i] : 0.0f;
  }
  auto load_w = [&](int cs, int buf) {
    bf16* wd = WB + buf * S2_CW * LQ;
    for (int i = tid; i < S2_CW * c8n; i += S2_THREADS) {
      const int r = i / c8n, c8 = (i % c8n) * 8;
      cp_async16(wd + r * LQ + c8, wk2 + (size_t)(cs * S2_CW + r) * C + c8);
    }
    // the slice of dout (bf16) and dd (float32) of the block's rows
    for (int i = tid; i < S2_RT * (S2_CW / 8); i += S2_THREADS) {
      const int r = i / (S2_CW / 8), c8 = (i % (S2_CW / 8)) * 8;
      bf16* dst = DOS + (buf * S2_RT + r) * S2_LD + c8;
      if (m0 + r < M) cp_async16(dst, dout + (size_t)(m0 + r) * C + cs * S2_CW + c8);
      else zero16(dst);
    }
    for (int i = tid; i < S2_RT * (S2_CW / 4); i += S2_THREADS) {
      const int r = i / (S2_CW / 4), c4 = (i % (S2_CW / 4)) * 4;
      float* dst = DDS + (buf * S2_RT + r) * S2_LF + c4;
      if (m0 + r < M) cp_async16(dst, dd + (size_t)(m0 + r) * C + cs * S2_CW + c4);
      else zero16(dst);
    }
    cp_async_commit();
  };

  // own frames and dout rows of this thread's two rows
  const int mA = m0 + rA, mB = m0 + rB;
  const int ownA = mA < M ? f0 + (mA % S) / N : -1;
  const int ownB = mB < M ? f0 + (mB % S) / N : -1;

  load_w(0, 0);
  for (int cs = 0; cs < ncs; ++cs) {
    const int buf = cs & 1;
    if (cs + 1 < ncs) {
      load_w(cs + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* W = WB + buf * S2_CW * LQ;
    float acc[MAX_F][4];
#pragma unroll
    for (int f = 0; f < MAX_F; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] = 0.0f;
    for (int h = 0; h < heads; ++h) {
      uint32_t a[HD / 16][4];
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        ldmatrix_x4(a[ks], Q2s + (rg * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LQ +
                               h * HD + ks * 16 + 8 * (lane >> 4));
      float gacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, W + (cq * 8 + (lane & 7)) * LQ + h * HD + kk * 32 + 8 * (lane >> 3));
        mma_16816(gacc, a[2 * kk], b[0], b[1]);
        mma_16816(gacc, a[2 * kk + 1], b[2], b[3]);
      }
      float la[MAX_F], lb[MAX_F];
      load_row_stats(DLS + rA * LH + h * F, F, la);
      load_row_stats(DLS + rB * LH + h * F, F, lb);
#pragma unroll
      for (int f = 0; f < MAX_F; ++f) {
        acc[f][0] = fmaf(la[f], gacc[0], acc[f][0]);
        acc[f][1] = fmaf(la[f], gacc[1], acc[f][1]);
        acc[f][2] = fmaf(lb[f], gacc[2], acc[f][2]);
        acc[f][3] = fmaf(lb[f], gacc[3], acc[f][3]);
      }
    }
    // value term, own-frame term, one rounding
    const int col = cs * S2_CW + cq * 8 + 2 * t;
    const int hc = col / HD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = half ? mB : mA, r = half ? rB : rA, own = half ? ownB : ownA;
      if (m >= M) continue;
      const float2 d = ld_bf16x2(DOS + (buf * S2_RT + r) * S2_LD + cq * 8 + 2 * t);
      const float2 e = *reinterpret_cast<const float2*>(
          DDS + (buf * S2_RT + r) * S2_LF + cq * 8 + 2 * t);
#pragma unroll
      for (int f = 0; f < MAX_F; ++f) {
        if (f >= F) break;
        const float w = A2S[r * LH + hc * F + f];
        float v0 = fmaf(w, d.x, acc[f][2 * half]);
        float v1 = fmaf(w, d.y, acc[f][2 * half + 1]);
        if (f == own) {
          v0 += e.x;
          v1 += e.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(dxs + ((size_t)m * F + f) * C + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncthreads();  // this buffer is refilled two slices on
  }
}

// ---- stage 1 on wgmma and TMA ------------------------------------------------
// Tiles of 64 channels are 128-byte rows in the 128-byte swizzled layout that
// TMA writes and wgmma's descriptors read (hopper_async.cuh). Thread block:
// two consumer warpgroups (64 rows each) and a producer warpgroup whose one
// issuing thread keeps the ring full; setmaxnreg gives the consumers the
// producer's registers.

constexpr int S1_WG = 2;
constexpr int S1_THREADS = 128 * (S1_WG + 1);
constexpr int S1_PRODUCER_REGS = 40;
constexpr int S1_CONSUMER_REGS = 232;
constexpr int ROW_BYTES = HD * 2;
constexpr int WG_TILE = 64 * ROW_BYTES;    // 64 rows
constexpr int S1_ROWS = 64 * S1_WG;        // queries (dq) or keys (dk/dv) a block
constexpr int S1_ALIGN = 1024;
constexpr int S1_BAR_BYTES = 1024;
constexpr int MAX_STAGES = 4;

// keys a frame is padded to: the instantiated wgmma widths, and past 256 two
// chunks of one (stage1_dq_chunked_kernel; kernel 1's chunk_keys)
__host__ __device__ constexpr int padded_keys(int n) {
  return n <= 64 ? 64
                 : (n <= 128 ? 128
                             : (n <= 208 ? 208
                                         : (n <= 256 ? 256
                                                     : (n <= 448 ? 448 : 512))));
}
constexpr int MAX_KEYS = 512;

// dq: a ring slot holds K_f and V_f [NP rows] and dO_f [128 rows]. Up to
// NP = 208 a consumer thread holds P and dP of a frame at once (208
// registers) and keeps its dq accumulators in shared memory between frames
// (dq_one_pass); at NP = 256 it forms dP twice over 64-key chunks instead.
__host__ __device__ constexpr bool dq_one_pass(int np) { return np <= 208; }
constexpr int DQ_ACC_BYTES = S1_WG * 128 * 32 * 4;   // 32 floats a thread
__host__ __device__ constexpr int dq_stage_bytes(int np) {
  return 2 * np * ROW_BYTES + S1_ROWS * ROW_BYTES;
}
__host__ __device__ constexpr int dq_fixed_bytes(int np) {
  return S1_ALIGN + S1_ROWS * ROW_BYTES + (dq_one_pass(np) ? DQ_ACC_BYTES : 0) +
         S1_BAR_BYTES;
}
__host__ __device__ constexpr int dq_stages(int np) {
  return (SMEM_LIMIT - dq_fixed_bytes(np)) / dq_stage_bytes(np) < 3
             ? (SMEM_LIMIT - dq_fixed_bytes(np)) / dq_stage_bytes(np)
             : 3;
}
__host__ __device__ constexpr int dq_smem_bytes(int np) {
  return dq_fixed_bytes(np) + dq_stages(np) * dq_stage_bytes(np);
}
static_assert(dq_stages(256) >= 2, "two frame slots at N = 256");

__device__ __forceinline__ void setmaxnreg_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(S1_PRODUCER_REGS));
}
__device__ __forceinline__ void setmaxnreg_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(S1_CONSUMER_REGS));
}

// The dq kernels' stores, by a consumer thread for its rows row0 and row1 =
// row0 + 8 (quad lane t4): frame f's statistics {lse2, r} (stp points at
// the frame's lse2 row, r lies a plane further) by the quad's first
// thread, and dq = scale * acc rounded to bf16.
__device__ __forceinline__ void dq_store_stats(float* stp, size_t plane,
                                               int S, int row0, int row1,
                                               int t4, float lse0, float lse1,
                                               float r0, float r1) {
  if (t4 != 0) return;
  if (row0 < S) {
    stp[row0] = lse0;
    stp[plane + row0] = r0;
  }
  if (row1 < S) {
    stp[row1] = lse1;
    stp[plane + row1] = r1;
  }
}

__device__ __forceinline__ void dq_store(bf16* dq, int b, int S, int C,
                                         int head, int row0, int row1,
                                         int t4, float scale,
                                         const float (&acc)[32]) {
  bf16* out0 = dq + ((size_t)b * S + row0) * C + head * HD + 2 * t4;
  bf16* out1 = dq + ((size_t)b * S + row1) * C + head * HD + 2 * t4;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * j) =
          __floats2bfloat162_rn(scale * acc[4 * j], scale * acc[4 * j + 1]);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * j) =
          __floats2bfloat162_rn(scale * acc[4 * j + 2], scale * acc[4 * j + 3]);
  }
}

// The stage-1 dq kernel: one block per 128 queries of a (batch row, head).
// Per frame: S = Q K_f^T by wgmma m64nNPk16 (4 k-steps), the softmax on the
// accumulators (keys >= N at -inf), dP = dO_f V_f^T the same way, r = sum_n
// P dP, dS = P (dP - r) in place of P, then dq += dS K_f (K read MN-major
// from the slot) with dS as hi + lo A fragments, four k-steps at a time. At
// NP = 256 dP goes in 64-key chunks, once for r and again for dS. Writes dq and stats[{lse2, r}][b][head]
// [f][s], lse2 = log2 of the softmax's denominator with the max folded in.
template <int NP>
__global__ void __launch_bounds__(S1_THREADS, 1) stage1_dq_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap o_map, bf16* __restrict__ dq,
    float* __restrict__ stats, int S, int S4, int F, int N, int C, int heads,
    float scale) {
  constexpr int KV = NP * ROW_BYTES;
  constexpr int STAGE = dq_stage_bytes(NP);
  constexpr int STAGES = dq_stages(NP);
  constexpr int NC = NP / 64;      // whole 64-key chunks
  constexpr int TAIL = NP % 64;    // 0, or 16 at NP = 208
  constexpr int SAFE_KEYS = NP == 64 ? 0 : (NP == 128 ? 64 : (NP == 208 ? 128 : 208));
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((S1_ALIGN - (cvta_smem(smem_raw) & (S1_ALIGN - 1))) &
                  (S1_ALIGN - 1));
  unsigned char* ring = smem;
  unsigned char* qbuf = ring + STAGES * STAGE;
  float* dqs = reinterpret_cast<float*>(qbuf + S1_ROWS * ROW_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      qbuf + S1_ROWS * ROW_BYTES + (dq_one_pass(NP) ? DQ_ACC_BYTES : 0));
  uint64_t* full = bars;
  uint64_t* empty = bars + MAX_STAGES;
  uint64_t* q_full = bars + 2 * MAX_STAGES;

  const int s0 = blockIdx.x * S1_ROWS, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * S1_WG);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * S1_WG) {  // the producer warpgroup: one thread issues
    setmaxnreg_producer();
    if (tid == 128 * S1_WG) {
      mbar_arrive_expect_tx(q_full, S1_ROWS * ROW_BYTES);
      tma_load_3d(qbuf, &q_map, q_full, head * HD, s0, b);
      for (int f = 0; f < F; ++f) {
        const int st = f % STAGES;
        const uint32_t ph = (f / STAGES) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&full[st], STAGE);
        unsigned char* slot = ring + st * STAGE;
        tma_load_3d(slot, &k_map, &full[st], head * HD, 0, b * F + f);
        tma_load_3d(slot + KV, &v_map, &full[st], head * HD, 0, b * F + f);
        tma_load_4d(slot + 2 * KV, &o_map, &full[st], head * HD, f, s0, b);
      }
    }
    return;
  }

  setmaxnreg_consumer();
  // rows 16 warp + g and + 8 of the warpgroup's 64, in the accumulators'
  // layout (element 4j + e: key / channel 8j + 2 t4 + (e & 1), the second
  // row for e >= 2)
  const int wg = tid >> 7, warp = (tid & 127) >> 5;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = s0 + wg * 64 + 16 * warp + g, row1 = row0 + 8;
  const float sl2 = scale * 1.4426950408889634f;
  const size_t plane = (size_t)gridDim.z * heads * F * S4;
  auto write_stats = [&](int f, float lse0, float lse1, float r0, float r1) {
    dq_store_stats(stats + (((size_t)b * heads + head) * F + f) * S4, plane,
                   S, row0, row1, t4, lse0, lse1, r0, r1);
  };
  auto write_dq = [&](const float (&acc)[32]) {
    dq_store(dq, b, S, C, head, row0, row1, t4, scale, acc);
  };
  mbar_wait(q_full, 0);
  const uint64_t qdesc = wgmma_desc_sw128(qbuf + wg * WG_TILE, 16, 1024);
  float dqacc[32];  // the chunked form's accumulators (NP = 256)
#pragma unroll
  for (int i = 0; i < 32; ++i) dqacc[i] = 0.0f;

  for (int f = 0; f < F; ++f) {
    const int st = f % STAGES;
    mbar_wait(&full[st], (f / STAGES) & 1);
    unsigned char* slot = ring + st * STAGE;
    unsigned char* vbase = slot + KV;
    const uint64_t kdesc = wgmma_desc_sw128(slot, 16, 1024);
    const uint64_t odesc = wgmma_desc_sw128(slot + 2 * KV + wg * WG_TILE, 16, 1024);

    float sacc[NP / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < HD / 16; ++k)
      wgmma_ss<NP>(sacc, qdesc + 2 * k, kdesc + 2 * k, k);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sacc);

    // true max-subtracted softmax over the frame's N keys, P normalised
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t4 + (e & 1);
        const float v = (8 * j + 8 <= SAFE_KEYS || key < N) ? sacc[4 * j + e]
                                                            : -INFINITY;
        sacc[4 * j + e] = v;
        if (e < 2) m0 = fmaxf(m0, v);
        else m1 = fmaxf(m1, v);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    const float mb0 = m0 * sl2, mb1 = m1 * sl2;
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(sacc[4 * j + e], sl2, e < 2 ? -mb0 : -mb1));
        sacc[4 * j + e] = p;
        if (e < 2) l0 += p;
        else l1 += p;
      }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      sacc[4 * j] *= inv0;
      sacc[4 * j + 1] *= inv0;
      sacc[4 * j + 2] *= inv1;
      sacc[4 * j + 3] *= inv1;
    }

    if constexpr (dq_one_pass(NP)) {
      float dp[NP / 2];
      wgmma_fence();
      const uint64_t vd = wgmma_desc_sw128(vbase, 16, 1024);
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        wgmma_ss<NP>(dp, odesc + 2 * k, vd + 2 * k, k);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dp);
      float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        r0 += sacc[4 * j] * dp[4 * j] + sacc[4 * j + 1] * dp[4 * j + 1];
        r1 += sacc[4 * j + 2] * dp[4 * j + 2] + sacc[4 * j + 3] * dp[4 * j + 3];
      }
      r0 = quad_sum(r0);
      r1 = quad_sum(r1);
      write_stats(f, mb0 + __log2f(l0), mb1 + __log2f(l1), r0, r1);
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {  // dS in place of P
        sacc[4 * j] *= dp[4 * j] - r0;
        sacc[4 * j + 1] *= dp[4 * j + 1] - r0;
        sacc[4 * j + 2] *= dp[4 * j + 2] - r1;
        sacc[4 * j + 3] *= dp[4 * j + 3] - r1;
      }
      float dqacc[32];
      float* mine = dqs + (size_t)(tid >> 5) * 32 * 32 + lane;
#pragma unroll
      for (int i = 0; i < 32; ++i) dqacc[i] = f > 0 ? mine[32 * i] : 0.0f;
      const uint64_t kd = wgmma_desc_sw128(slot, 16, 1024);
      constexpr int KSTEPS = NP / 16;
#pragma unroll
      for (int g4 = 0; g4 < (KSTEPS + 3) / 4; ++g4) {
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = 4 * g4 + q;
          if (kk >= KSTEPS) break;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int js = 2 * kk + half;
            split_bf16x2(sacc[4 * js], sacc[4 * js + 1], hi[q][2 * half],
                         lo[q][2 * half]);
            split_bf16x2(sacc[4 * js + 2], sacc[4 * js + 3],
                         hi[q][2 * half + 1], lo[q][2 * half + 1]);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = 4 * g4 + q;
          if (kk >= KSTEPS) break;
          wgmma_rs_n64_tb(dqacc, hi[q], kd + (uint64_t)(kk * 128), 1);
          wgmma_rs_n64_tb(dqacc, lo[q], kd + (uint64_t)(kk * 128), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dqacc);
      }
      mbar_arrive(&empty[st]);  // this frame's slot is read for the last time
      if (f + 1 < F) {
#pragma unroll
        for (int i = 0; i < 32; ++i) mine[32 * i] = dqacc[i];
      } else {
        write_dq(dqacc);
      }
      continue;
    }

    // pass 1: r = sum_n P dP
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float dp[32];
      const uint64_t vd = wgmma_desc_sw128(vbase + c * WG_TILE, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        wgmma_ss_n64(dp, odesc + 2 * k, vd + 2 * k, k);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        r0 += sacc[(8 * c + j) * 4] * dp[4 * j] + sacc[(8 * c + j) * 4 + 1] * dp[4 * j + 1];
        r1 += sacc[(8 * c + j) * 4 + 2] * dp[4 * j + 2] + sacc[(8 * c + j) * 4 + 3] * dp[4 * j + 3];
      }
    }
    if constexpr (TAIL > 0) {
      float dp[TAIL / 2];
      const uint64_t vd = wgmma_desc_sw128(vbase + NC * WG_TILE, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        wgmma_ss<TAIL>(dp, odesc + 2 * k, vd + 2 * k, k);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int j = 0; j < TAIL / 8; ++j) {
        r0 += sacc[(8 * NC + j) * 4] * dp[4 * j] + sacc[(8 * NC + j) * 4 + 1] * dp[4 * j + 1];
        r1 += sacc[(8 * NC + j) * 4 + 2] * dp[4 * j + 2] + sacc[(8 * NC + j) * 4 + 3] * dp[4 * j + 3];
      }
    }
    r0 = quad_sum(r0);
    r1 = quad_sum(r1);
    write_stats(f, mb0 + __log2f(l0), mb1 + __log2f(l1), r0, r1);

    // pass 2: dS = P (dP - r) as hi + lo A fragments, dq += dS K
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float dp[32];
      const uint64_t vd = wgmma_desc_sw128(vbase + c * WG_TILE, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        wgmma_ss_n64(dp, odesc + 2 * k, vd + 2 * k, k);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dp);
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int jl = 2 * kk + half, js = 8 * c + jl;
          split_bf16x2(sacc[4 * js] * (dp[4 * jl] - r0),
                       sacc[4 * js + 1] * (dp[4 * jl + 1] - r0),
                       hi[kk][2 * half], lo[kk][2 * half]);
          split_bf16x2(sacc[4 * js + 2] * (dp[4 * jl + 2] - r1),
                       sacc[4 * js + 3] * (dp[4 * jl + 3] - r1),
                       hi[kk][2 * half + 1], lo[kk][2 * half + 1]);
        }
      }
      const uint64_t kd = wgmma_desc_sw128(slot + c * WG_TILE, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n64_tb(dqacc, hi[kk], kd + (uint64_t)(kk * 128), 1);
        wgmma_rs_n64_tb(dqacc, lo[kk], kd + (uint64_t)(kk * 128), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dqacc);
    }
    if constexpr (TAIL > 0) {
      float dp[TAIL / 2];
      const uint64_t vd = wgmma_desc_sw128(vbase + NC * WG_TILE, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        wgmma_ss<TAIL>(dp, odesc + 2 * k, vd + 2 * k, k);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dp);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int js = 8 * NC + half;
        split_bf16x2(sacc[4 * js] * (dp[4 * half] - r0),
                     sacc[4 * js + 1] * (dp[4 * half + 1] - r0), hi[2 * half],
                     lo[2 * half]);
        split_bf16x2(sacc[4 * js + 2] * (dp[4 * half + 2] - r1),
                     sacc[4 * js + 3] * (dp[4 * half + 3] - r1),
                     hi[2 * half + 1], lo[2 * half + 1]);
      }
      const uint64_t kd = wgmma_desc_sw128(slot + NC * WG_TILE, 16, 1024);
      wgmma_fence();
      wgmma_rs_n64_tb(dqacc, hi, kd, 1);
      wgmma_rs_n64_tb(dqacc, lo, kd, 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dqacc);
    }
    mbar_arrive(&empty[st]);  // this frame's slot is read for the last time
  }
  if constexpr (!dq_one_pass(NP)) write_dq(dqacc);
}

// dq at 256 < N <= 512 keys a frame (the 336 crop's 441 and 445). A frame
// is too wide for one consumer's registers (NP = 448 alone is 224 floats of
// logits a thread) and for a ring slot (K_f and V_f 115 to 128 KB), so the
// keys go in two chunks of CH (kernel 1's chunk_keys: 224 up to N = 448,
// else 256). A ring slot holds K_c and V_c [CH rows] and dO_f [128 rows],
// and the producer streams each frame's two chunks twice, in two sweeps:
//   sweep 1: S_c = Q K_c^T and dP_c = dO V_c^T (64 keys at a time), the row
//     max m, l = sum exp(s - m) and r' = sum exp(s - m) dP carried online
//     (both scaled by exp(m_old - m_new) when chunk 1 raises the max); then
//     r = r' / l and lse2 = log2 of the denominator with the max folded in;
//   sweep 2: S_c and dP_c again, P_c = exp2(s scale log2(e) - lse2) (as the
//     dk/dv kernel forms it), dS_c = P_c (dP_c - r), and dq += dS_c K_c with
//     dS as hi + lo A fragments.
// r stays a dP sum: r = dxs . xs from stage 2's bf16 operands misses dq's
// gate. Sweep 2 re-reads K and V from L2 rather than keeping a frame's two
// chunks resident, which would leave room for one slot and no overlap of
// copies and products.
__host__ __device__ constexpr int dq_chunk_keys(int np) { return np / 2; }
__host__ __device__ constexpr int dqc_stage_bytes(int ch) {
  return 2 * ch * ROW_BYTES + S1_ROWS * ROW_BYTES;
}
constexpr int DQC_FIXED_BYTES = S1_ALIGN + S1_ROWS * ROW_BYTES + S1_BAR_BYTES;
__host__ __device__ constexpr int dqc_stages(int ch) {
  return (SMEM_LIMIT - DQC_FIXED_BYTES) / dqc_stage_bytes(ch) < 3
             ? (SMEM_LIMIT - DQC_FIXED_BYTES) / dqc_stage_bytes(ch)
             : 3;
}
__host__ __device__ constexpr int dqc_smem_bytes(int ch) {
  return DQC_FIXED_BYTES + dqc_stages(ch) * dqc_stage_bytes(ch);
}
static_assert(dqc_stages(224) >= 2 && dqc_stages(256) >= 2,
              "two chunk slots at N = 448 and 512");

// dp[64 x W] = dO_f (the warpgroup's 64 rows) . V[W keys from v]^T
template <int W>
__device__ __forceinline__ void dq_dp(float (&dp)[W / 2], uint64_t odesc,
                                      const unsigned char* v) {
  const uint64_t vd = wgmma_desc_sw128(v, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) wgmma_ss<W>(dp, odesc + 2 * k, vd + 2 * k, k);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(dp);
}

// dq += dS K over W keys of the chunk from 8-key group j0 on: dS = P (dP -
// r) from the chunk's P (sacc) and dp of those keys, as hi + lo A fragments
// (W / 16 k-steps); kd addresses K's first key of the group (MN-major).
// j0 is a constant once the caller's loop is unrolled.
template <int W, int NS>
__device__ __forceinline__ void dq_accumulate(float (&dqacc)[32],
                                              const float (&sacc)[NS],
                                              const float (&dp)[W / 2],
                                              int j0, float r0, float r1,
                                              uint64_t kd) {
  constexpr int KS = W / 16;
  uint32_t hi[KS][4], lo[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jl = 2 * kk + half, js = j0 + jl;
      split_bf16x2(sacc[4 * js] * (dp[4 * jl] - r0),
                   sacc[4 * js + 1] * (dp[4 * jl + 1] - r0), hi[kk][2 * half],
                   lo[kk][2 * half]);
      split_bf16x2(sacc[4 * js + 2] * (dp[4 * jl + 2] - r1),
                   sacc[4 * js + 3] * (dp[4 * jl + 3] - r1),
                   hi[kk][2 * half + 1], lo[kk][2 * half + 1]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_rs_n64_tb(dqacc, hi[kk], kd + (uint64_t)(kk * 128), 1);
    wgmma_rs_n64_tb(dqacc, lo[kk], kd + (uint64_t)(kk * 128), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(dqacc);
}

// S_c = Q K_c^T for the warpgroup's 64 queries and the CH keys of the slot,
// the keys at or past N (valid keys in this chunk) at -inf
template <int CH>
__device__ __forceinline__ void dq_chunk_logits(float (&sacc)[CH / 2],
                                                uint64_t qdesc,
                                                const unsigned char* slot,
                                                int valid, int t4) {
  const uint64_t kdesc = wgmma_desc_sw128(slot, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < HD / 16; ++k)
    wgmma_ss<CH>(sacc, qdesc + 2 * k, kdesc + 2 * k, k);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(sacc);
  if (valid < CH) {
#pragma unroll
    for (int j = 0; j < CH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t4 + (e & 1) >= valid) sacc[4 * j + e] = -INFINITY;
  }
}

// The chunked dq kernel: one block per 128 queries of a (batch row, head),
// as stage1_dq_kernel; ring slot i = 4 f + 2 sweep + chunk. Writes dq and
// the row statistics in stage1_dq_kernel's layout.
template <int CH>
__global__ void __launch_bounds__(S1_THREADS, 1) stage1_dq_chunked_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap o_map, bf16* __restrict__ dq,
    float* __restrict__ stats, int S, int S4, int F, int N, int C, int heads,
    float scale) {
  constexpr int KV = CH * ROW_BYTES;
  constexpr int STAGE = dqc_stage_bytes(CH);
  constexpr int STAGES = dqc_stages(CH);
  constexpr int NC = CH / 64;      // whole 64-key groups of a chunk
  constexpr int TAIL = CH % 64;    // 0, or 32 at CH = 224: two 16-key steps
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((S1_ALIGN - (cvta_smem(smem_raw) & (S1_ALIGN - 1))) &
                  (S1_ALIGN - 1));
  unsigned char* ring = smem;
  unsigned char* qbuf = ring + STAGES * STAGE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(qbuf + S1_ROWS * ROW_BYTES);
  uint64_t* full = bars;
  uint64_t* empty = bars + MAX_STAGES;
  uint64_t* q_full = bars + 2 * MAX_STAGES;

  const int s0 = blockIdx.x * S1_ROWS, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * S1_WG);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * S1_WG) {  // the producer warpgroup: one thread starts the copies
    setmaxnreg_producer();
    if (tid == 128 * S1_WG) {
      mbar_arrive_expect_tx(q_full, S1_ROWS * ROW_BYTES);
      tma_load_3d(qbuf, &q_map, q_full, head * HD, s0, b);
      for (int i = 0; i < 4 * F; ++i) {
        const int f = i >> 2, c = i & 1;
        const int st = i % STAGES;
        const uint32_t ph = (i / STAGES) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&full[st], STAGE);
        unsigned char* slot = ring + st * STAGE;
        tma_load_3d(slot, &k_map, &full[st], head * HD, c * CH, b * F + f);
        tma_load_3d(slot + KV, &v_map, &full[st], head * HD, c * CH, b * F + f);
        tma_load_4d(slot + 2 * KV, &o_map, &full[st], head * HD, f, s0, b);
      }
    }
    return;
  }

  setmaxnreg_consumer();
  const int wg = tid >> 7, warp = (tid & 127) >> 5;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = s0 + wg * 64 + 16 * warp + g, row1 = row0 + 8;
  const float sl2 = scale * 1.4426950408889634f;
  const size_t plane = (size_t)gridDim.z * heads * F * S4;
  mbar_wait(q_full, 0);
  const uint64_t qdesc = wgmma_desc_sw128(qbuf + wg * WG_TILE, 16, 1024);
  float dqacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqacc[i] = 0.0f;
  float sacc[CH / 2];

  int i = 0;  // ring slots consumed
  for (int f = 0; f < F; ++f) {
    const uint64_t odesc_off = 2 * KV + wg * WG_TILE;
    // sweep 1: the online max, l and r' (per-thread partial sums)
    float m0 = -INFINITY, m1 = -INFINITY;
    float l0 = 0.0f, l1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll 1
    for (int c = 0; c < 2; ++c, ++i) {
      const int st = i % STAGES;
      mbar_wait(&full[st], (i / STAGES) & 1);
      unsigned char* slot = ring + st * STAGE;
      const uint64_t odesc = wgmma_desc_sw128(slot + odesc_off, 16, 1024);
      dq_chunk_logits<CH>(sacc, qdesc, slot, N - c * CH, t4);
      float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < CH / 8; ++j) {
        c0 = fmaxf(c0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        c1 = fmaxf(c1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, o));
        c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, o));
      }
      const float n0 = fmaxf(m0, c0), n1 = fmaxf(m1, c1);
      const float mb0 = n0 * sl2, mb1 = n1 * sl2;
      const float a0 = fast_exp2(m0 * sl2 - mb0), a1 = fast_exp2(m1 * sl2 - mb1);
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      q0 *= a0;
      l1 *= a1;
      q1 *= a1;
#pragma unroll
      for (int j = 0; j < CH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(sacc[4 * j + e], sl2, e < 2 ? -mb0 : -mb1));
          sacc[4 * j + e] = p;
          if (e < 2) l0 += p;
          else l1 += p;
        }
      unsigned char* vbase = slot + KV;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        float dp[32];
        dq_dp<64>(dp, odesc, vbase + cc * WG_TILE);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int js = 8 * cc + j;
          q0 += sacc[4 * js] * dp[4 * j] + sacc[4 * js + 1] * dp[4 * j + 1];
          q1 += sacc[4 * js + 2] * dp[4 * j + 2] + sacc[4 * js + 3] * dp[4 * j + 3];
        }
      }
#pragma unroll
      for (int u = 0; u < TAIL / 16; ++u) {
        float dp[8];
        dq_dp<16>(dp, odesc, vbase + NC * WG_TILE + u * 16 * ROW_BYTES);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int js = 8 * NC + 2 * u + j;
          q0 += sacc[4 * js] * dp[4 * j] + sacc[4 * js + 1] * dp[4 * j + 1];
          q1 += sacc[4 * js + 2] * dp[4 * j + 2] + sacc[4 * js + 3] * dp[4 * j + 3];
        }
      }
      mbar_arrive(&empty[st]);
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float r0 = quad_sum(q0) / l0, r1 = quad_sum(q1) / l1;
    const float lse0 = m0 * sl2 + __log2f(l0), lse1 = m1 * sl2 + __log2f(l1);
    dq_store_stats(stats + (((size_t)b * heads + head) * F + f) * S4, plane,
                   S, row0, row1, t4, lse0, lse1, r0, r1);

    // sweep 2: P, dS = P (dP - r) and dq += dS K
#pragma unroll 1
    for (int c = 0; c < 2; ++c, ++i) {
      const int st = i % STAGES;
      mbar_wait(&full[st], (i / STAGES) & 1);
      unsigned char* slot = ring + st * STAGE;
      const uint64_t odesc = wgmma_desc_sw128(slot + odesc_off, 16, 1024);
      dq_chunk_logits<CH>(sacc, qdesc, slot, N - c * CH, t4);
#pragma unroll
      for (int j = 0; j < CH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[4 * j + e] =
              fast_exp2(fmaf(sacc[4 * j + e], sl2, e < 2 ? -lse0 : -lse1));
      unsigned char* vbase = slot + KV;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        float dp[32];
        dq_dp<64>(dp, odesc, vbase + cc * WG_TILE);
        dq_accumulate<64>(dqacc, sacc, dp, 8 * cc, r0, r1,
                          wgmma_desc_sw128(slot + cc * WG_TILE, 16, 1024));
      }
#pragma unroll
      for (int u = 0; u < TAIL / 16; ++u) {
        float dp[8];
        dq_dp<16>(dp, odesc, vbase + NC * WG_TILE + u * 16 * ROW_BYTES);
        dq_accumulate<16>(dqacc, sacc, dp, 8 * NC + 2 * u, r0, r1,
                          wgmma_desc_sw128(slot + NC * WG_TILE, 16, 1024) +
                              (uint64_t)(u * 128));
      }
      mbar_arrive(&empty[st]);  // this chunk's slot is read for the last time
    }
  }

  dq_store(dq, b, S, C, head, row0, row1, t4, scale, dqacc);
}

// dk/dv: a ring slot holds a chunk of 64 queries: Q, dO of each frame the
// block's keys touch, and the statistics of every frame [2][F][64] (float32)
constexpr int QC = 64;

__host__ __device__ inline int kv_frames(int N, int F) {
  const int n = (S1_ROWS - 1) / N + 2;
  return n < F ? n : F;
}
__host__ __device__ inline int kv_stat_bytes(int F) {
  return (int)round_up((size_t)2 * F * QC * sizeof(float), S1_ALIGN);
}
__host__ __device__ inline int kv_stage_bytes(int N, int F) {
  return QC * ROW_BYTES * (1 + kv_frames(N, F)) + kv_stat_bytes(F);
}
__host__ __device__ inline int kv_fixed_bytes() {
  return S1_ALIGN + 2 * S1_ROWS * ROW_BYTES + S1_BAR_BYTES;
}
inline int kv_stages(int N, int F) {
  const int n = (SMEM_LIMIT - kv_fixed_bytes()) / kv_stage_bytes(N, F);
  return n < MAX_STAGES ? n : MAX_STAGES;
}

// The stage-1 dk/dv kernel: one block per 128 keys of a (batch row, head),
// the keys of all frames in one run (key j = f N + n). Per chunk of 64
// queries: S^T = K Q^T and dP^T = V dO_f^T for each frame f the warpgroup's
// 64 keys touch (a row keeps its own frame's), P^T = exp2(scale log2(e)
// S^T - lse2[f(row)]) and dS^T = P^T (dP^T - r[f(row)]) in float32, then
// dv += P^T dO_f (rows of other frames masked) and dk += dS^T Q (hi + lo),
// Q and dO read MN-major from the slot.
__global__ void __launch_bounds__(S1_THREADS, 1) stage1_dkdv_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap o_map,
    const __grid_constant__ CUtensorMap st_map, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int B, int S, int F, int N, int C, int heads,
    float scale, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((S1_ALIGN - (cvta_smem(smem_raw) & (S1_ALIGN - 1))) &
                  (S1_ALIGN - 1));
  const int nfmax = kv_frames(N, F);
  const int stage_bytes = kv_stage_bytes(N, F);
  unsigned char* kbuf = smem;
  unsigned char* vbuf = kbuf + S1_ROWS * ROW_BYTES;
  unsigned char* ring = vbuf + S1_ROWS * ROW_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
  uint64_t* full = bars;
  uint64_t* empty = bars + MAX_STAGES;
  uint64_t* kv_full = bars + 2 * MAX_STAGES;

  const int FN = F * N;
  const int j0 = blockIdx.x * S1_ROWS, head = blockIdx.y, b = blockIdx.z;
  const int fu_lo = j0 / N;
  const int fu_hi = min(F - 1, (min(j0 + S1_ROWS, FN) - 1) / N);
  const int nch = (S + QC - 1) / QC;
  const int sbytes = F * QC * (int)sizeof(float);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * S1_WG);
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * S1_WG) {
    setmaxnreg_producer();
    if (tid == 128 * S1_WG) {
      mbar_arrive_expect_tx(kv_full, 2 * S1_ROWS * ROW_BYTES);
      tma_load_3d(kbuf, &k_map, kv_full, head * HD, j0, b);
      tma_load_3d(vbuf, &v_map, kv_full, head * HD, j0, b);
      const int nfu = fu_hi - fu_lo + 1;
      for (int c = 0; c < nch; ++c) {
        const int st = c % stages;
        const uint32_t ph = (c / stages) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&full[st], QC * ROW_BYTES * (1 + nfu) + 2 * sbytes);
        unsigned char* slot = ring + st * stage_bytes;
        tma_load_3d(slot, &q_map, &full[st], head * HD, c * QC, b);
        for (int i = 0; i < nfu; ++i)
          tma_load_4d(slot + QC * ROW_BYTES * (1 + i), &o_map, &full[st],
                      head * HD, fu_lo + i, c * QC, b);
        unsigned char* sb = slot + QC * ROW_BYTES * (1 + nfmax);
        tma_load_3d(sb, &st_map, &full[st], c * QC, 0, b * heads + head);
        tma_load_3d(sb + sbytes, &st_map, &full[st], c * QC, 0,
                    (B + b) * heads + head);
      }
    }
    return;
  }

  setmaxnreg_consumer();
  const int wg = tid >> 7, warp = (tid & 127) >> 5;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int kA = j0 + wg * 64 + 16 * warp + g, kB = kA + 8;  // key rows
  const bool vA = kA < FN, vB = kB < FN;
  const int fA = vA ? kA / N : F - 1, fB = vB ? kB / N : F - 1;
  const int wlo = j0 + wg * 64;
  const bool active = wlo < FN;
  const int wf_lo = active ? wlo / N : 0;
  const int wf_hi = active ? (min(wlo + 64, FN) - 1) / N : 0;
  const float sl2 = scale * 1.4426950408889634f;
  const uint64_t kd = wgmma_desc_sw128(kbuf + wg * WG_TILE, 16, 1024);
  const uint64_t vd = wgmma_desc_sw128(vbuf + wg * WG_TILE, 16, 1024);
  float dkacc[32], dvacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dkacc[i] = dvacc[i] = 0.0f;
  if (active) mbar_wait(kv_full, 0);

  for (int c = 0; c < nch; ++c) {
    const int st = c % stages;
    mbar_wait(&full[st], (c / stages) & 1);
    if (!active) {
      mbar_arrive(&empty[st]);
      continue;
    }
    unsigned char* slot = ring + st * stage_bytes;
    const float* lse = reinterpret_cast<const float*>(slot + QC * ROW_BYTES * (1 + nfmax));
    const float* rst = lse + F * QC;
    const uint64_t qd = wgmma_desc_sw128(slot, 16, 1024);
    auto odesc = [&](int f) {
      return wgmma_desc_sw128(slot + QC * ROW_BYTES * (1 + f - fu_lo), 16, 1024);
    };

    float sacc[32], dpacc[32];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) wgmma_ss_n64(sacc, kd + 2 * k, qd + 2 * k, k);
    const uint64_t od0 = odesc(wf_lo);
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) wgmma_ss_n64(dpacc, vd + 2 * k, od0 + 2 * k, k);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sacc);
    reg_fence(dpacc);
    for (int fr = wf_lo + 1; fr <= wf_hi; ++fr) {  // rows of a later frame
      float dp2[32];
      const uint64_t od = odesc(fr);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) wgmma_ss_n64(dp2, vd + 2 * k, od + 2 * k, k);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dp2);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i & 2) ? fB : fA) == fr) dpacc[i] = dp2[i];
    }

    // P^T and dS^T, rows: keys, columns: the chunk's queries
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1);
        const int fr = e < 2 ? fA : fB;
        const bool ok = (e < 2 ? vA : vB) && c * QC + col < S;
        // (statistics past S are not written: read them for valid queries)
        const float p = ok ? fast_exp2(fmaf(sacc[4 * j + e], sl2, -lse[fr * QC + col]))
                           : 0.0f;
        dpacc[4 * j + e] = ok ? p * (dpacc[4 * j + e] - rst[fr * QC + col]) : 0.0f;
        sacc[4 * j + e] = p;
      }
    uint32_t pa[4][4], dsh[4][4], dsl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * kk + 2 * q;
        pa[kk][q] = pack_bf16x2(sacc[i], sacc[i + 1]);
        split_bf16x2(dpacc[i], dpacc[i + 1], dsh[kk][q], dsl[kk][q]);
      }
    }
    if (wf_lo == wf_hi) {
      const uint64_t od = odesc(wf_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64_tb(dvacc, pa[kk], od + (uint64_t)(kk * 128), 1);
    } else {
      for (int fr = wf_lo; fr <= wf_hi; ++fr) {  // each frame's rows alone
        uint32_t pm[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            pm[kk][q] = (((q & 1) ? fB : fA) == fr) ? pa[kk][q] : 0u;
        const uint64_t od = odesc(fr);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n64_tb(dvacc, pm[kk], od + (uint64_t)(kk * 128), 1);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dvacc);
      }
      wgmma_fence();
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64_tb(dkacc, dsh[kk], qd + (uint64_t)(kk * 128), 1);
      wgmma_rs_n64_tb(dkacc, dsl[kk], qd + (uint64_t)(kk * 128), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dkacc);
    reg_fence(dvacc);
    mbar_arrive(&empty[st]);
  }

  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? kB : kA;
    if (key >= FN) continue;
    const size_t o = ((size_t)b * FN + key) * C + head * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * j) = __floats2bfloat162_rn(
          scale * dkacc[4 * j + 2 * half], scale * dkacc[4 * j + 2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * j) = __floats2bfloat162_rn(
          dvacc[4 * j + 2 * half], dvacc[4 * j + 2 * half + 1]);
    }
  }
}

template <int NP>
cudaError_t launch_stage1_dq(const bf16* q, const bf16* kf, const bf16* vf,
                             const bf16* dxs, bf16* dq, float* stats, int B,
                             int S, int S4, int F, int N, int C, int heads,
                             float scale, cudaStream_t st) {
  CUtensorMap qm, km, vm, om;
  const cuuint64_t row = (cuuint64_t)C * 2;
  {  // q [B, S, C]: 128 rows of one head
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[2] = {row, row * S};
    const cuuint32_t box[3] = {HD, S1_ROWS, 1};
    const cudaError_t e = make_bf16_map(&qm, q, 3, dims, strides, box);
    if (e != cudaSuccess) return e;
  }
  // past 256 keys the chunked kernel, which copies a chunk at a time
  constexpr bool chunked = NP > 256;
  constexpr int CH = chunked ? dq_chunk_keys(NP) : NP;
  {  // kf, vf [B F, N, C]: a frame's NP keys (chunked: CH keys) of one head
     // (past N: zeros)
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)B * F};
    const cuuint64_t strides[2] = {row, row * N};
    const cuuint32_t box[3] = {HD, CH, 1};
    cudaError_t e = make_bf16_map(&km, kf, 3, dims, strides, box);
    if (e != cudaSuccess) return e;
    e = make_bf16_map(&vm, vf, 3, dims, strides, box);
    if (e != cudaSuccess) return e;
  }
  {  // dxs [B, S, F, C]: 128 rows of one frame and head
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)F, (cuuint64_t)S,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {row, row * F, row * F * S};
    const cuuint32_t box[4] = {HD, 1, S1_ROWS, 1};
    const cudaError_t e = make_bf16_map(&om, dxs, 4, dims, strides, box);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + S1_ROWS - 1) / S1_ROWS, heads, B);
  if constexpr (chunked) {
    constexpr int smem = dqc_smem_bytes(CH);
    static const cudaError_t attr =
        set_smem((const void*)stage1_dq_chunked_kernel<CH>, smem);
    if (attr != cudaSuccess) return attr;
    stage1_dq_chunked_kernel<CH><<<grid, S1_THREADS, smem, st>>>(
        qm, km, vm, om, dq, stats, S, S4, F, N, C, heads, scale);
  } else {
    constexpr int smem = dq_smem_bytes(NP);
    static const cudaError_t attr =
        set_smem((const void*)stage1_dq_kernel<NP>, smem);
    if (attr != cudaSuccess) return attr;
    stage1_dq_kernel<NP><<<grid, S1_THREADS, smem, st>>>(
        qm, km, vm, om, dq, stats, S, S4, F, N, C, heads, scale);
  }
  ++launches;
  return cudaGetLastError();
}

cudaError_t launch_stage1_dkdv(const bf16* q, const bf16* kf, const bf16* vf,
                               const bf16* dxs, const float* stats, bf16* dk,
                               bf16* dv, int B, int S, int S4, int F, int N,
                               int C, int heads, float scale,
                               cudaStream_t st) {
  CUtensorMap qm, km, vm, om, sm;
  const cuuint64_t row = (cuuint64_t)C * 2;
  {  // q [B, S, C]: a chunk of 64 queries of one head
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[2] = {row, row * S};
    const cuuint32_t box[3] = {HD, QC, 1};
    const cudaError_t e = make_bf16_map(&qm, q, 3, dims, strides, box);
    if (e != cudaSuccess) return e;
  }
  {  // kf, vf as [B, F N, C]: 128 keys of one head (past F N: zeros)
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)F * N, (cuuint64_t)B};
    const cuuint64_t strides[2] = {row, row * F * N};
    const cuuint32_t box[3] = {HD, S1_ROWS, 1};
    cudaError_t e = make_bf16_map(&km, kf, 3, dims, strides, box);
    if (e != cudaSuccess) return e;
    e = make_bf16_map(&vm, vf, 3, dims, strides, box);
    if (e != cudaSuccess) return e;
  }
  {  // dxs [B, S, F, C]: 64 queries of one frame and head
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)F, (cuuint64_t)S,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {row, row * F, row * F * S};
    const cuuint32_t box[4] = {HD, 1, QC, 1};
    const cudaError_t e = make_bf16_map(&om, dxs, 4, dims, strides, box);
    if (e != cudaSuccess) return e;
  }
  {  // stats [2 B heads, F, S4] float32: 64 queries of every frame
    const cuuint64_t dims[3] = {(cuuint64_t)S4, (cuuint64_t)F,
                                (cuuint64_t)2 * B * heads};
    const cuuint64_t strides[2] = {(cuuint64_t)S4 * 4, (cuuint64_t)S4 * 4 * F};
    const cuuint32_t box[3] = {QC, (cuuint32_t)F, 1};
    const cudaError_t e = make_f32_map(&sm, stats, 3, dims, strides, box);
    if (e != cudaSuccess) return e;
  }
  const int stages = kv_stages(N, F);
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = (size_t)kv_fixed_bytes() + (size_t)stages * kv_stage_bytes(N, F);
  cudaError_t e = set_smem((const void*)stage1_dkdv_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((F * N + S1_ROWS - 1) / S1_ROWS, heads, B);
  stage1_dkdv_kernel<<<grid, S1_THREADS, smem, st>>>(
      qm, km, vm, om, sm, dk, dv, B, S, F, N, C, heads, scale, stages);
  ++launches;
  return cudaGetLastError();
}

// f(std::integral_constant<int, HPW>) with HPW = ceil(heads / 4), the heads
// a warp of the stage-2 row and dWk2 kernels takes
template <class Fn>
cudaError_t with_heads_per_warp(int heads, Fn&& f) {
  switch ((heads + 3) / 4) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    default: return f(std::integral_constant<int, 4>{});
  }
}

int backward(const bf16* q, const bf16* kf, const bf16* vf, const bf16* wq2,
             const bf16* wk2, const bf16* dout, const bf16* xs, const bf16* q2,
             bf16* dq, bf16* dkf, bf16* dvf, float* dwq2, float* dbq2,
             float* dwk2, float* a2, float* dl2, bf16* dxs, float* dq2,
             bf16* dq2b, float* dd, float* part, float* wpart, float* bpart,
             float* stats, int B, int S, int F, int N, int C, int heads,
             float scale, cudaStream_t st, int f0) {
  cudaError_t err;
  const int M = B * S;
  const int S4 = (int)round_up((size_t)S, 4);

  // logits, a2, dl2, dq2 and the dbq2 partials
  err = with_heads_per_warp(heads, [&](auto hpw) {
    constexpr int HPW = decltype(hpw)::value;
    const size_t smem = rows_smem(C, F, heads);
    const cudaError_t e = set_smem((const void*)stage2_rows_kernel<HPW>, smem);
    if (e != cudaSuccess) return e;
    stage2_rows_kernel<HPW><<<(M + S2_RT - 1) / S2_RT, S2_THREADS, smem, st>>>(
        xs, q2, dout, wk2, a2, dl2, dq2, dq2b, bpart, M, F, C, heads, scale);
    ++launches;
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;

  // dd = dq2 . Wq2^T (float32)
  GemmArgs gd = {};
  gd.a = dq2b; gd.lda = C; gd.b = wq2; gd.ldb = C;
  gd.M = M; gd.N = C; gd.K = C; gd.k_chunk = C;
  gd.out = dd;
  if ((err = gemm<false, true>(gd, 1, st)) != cudaSuccess) return err;

  // dWq2 = x_diag^T . dq2 over the M rows (own-frame rows of xs), split-K
  GemmArgs gq = {};
  // a window's own frame f0 + s / N: the gather's rows start f0 frames in
  gq.a = xs + (size_t)f0 * C; gq.lda = C; gq.gather = 1; gq.S = S; gq.Nk = N;
  gq.F = F;
  gq.b = dq2b; gq.ldb = C;
  gq.M = C; gq.N = C; gq.K = M; gq.k_chunk = split_chunk(M);
  gq.out = part; gq.out_z = (size_t)C * C;
  if ((err = gemm<true, false>(gq, SPLITS, st)) != cudaSuccess) return err;

  // dWk2 partials over W_SPLITS row ranges
  err = with_heads_per_warp(heads, [&](auto hpw) {
    constexpr int HPW = decltype(hpw)::value;
    const size_t smem = dwk2_smem(C, F, heads);
    const cudaError_t e = set_smem((const void*)stage2_dwk2_kernel<HPW>, smem);
    if (e != cudaSuccess) return e;
    const int rows_per = (int)round_up((size_t)(M + W_SPLITS - 1) / W_SPLITS, S2_RT);
    stage2_dwk2_kernel<HPW><<<dim3(C / S2_CW, W_SPLITS), S2_THREADS, smem, st>>>(
        xs, q2, dl2, wpart, M, F, C, heads, rows_per);
    ++launches;
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;

  // dxs (bf16)
  {
    const size_t smem = dxs_smem(C, F, heads);
    if ((err = set_smem((const void*)stage2_dxs_kernel, smem)) != cudaSuccess)
      return err;
    stage2_dxs_kernel<<<(M + S2_RT - 1) / S2_RT, S2_THREADS, smem, st>>>(
        q2, wk2, dout, a2, dl2, dd, dxs, M, S, N, F, C, heads, f0);
    ++launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  // the three fixed-order sums
  {
    SumJobs jobs;
    jobs.job[0] = {part, dwq2, C * C, SPLITS};
    jobs.job[1] = {wpart, dwk2, C * C, W_SPLITS};
    jobs.job[2] = {bpart, dbq2, C, 2 * ((M + S2_RT - 1) / S2_RT)};
    sum_splits_kernel<<<dim3(min((C * C / 4 + 255) / 256, 1024), 3), 256, 0, st>>>(jobs);
    ++launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  // stage 1: dq (and the row statistics), then dk and dv
  switch (padded_keys(N)) {
    case 64:
      err = launch_stage1_dq<64>(q, kf, vf, dxs, dq, stats, B, S, S4, F, N, C, heads, scale, st);
      break;
    case 128:
      err = launch_stage1_dq<128>(q, kf, vf, dxs, dq, stats, B, S, S4, F, N, C, heads, scale, st);
      break;
    case 208:
      err = launch_stage1_dq<208>(q, kf, vf, dxs, dq, stats, B, S, S4, F, N, C, heads, scale, st);
      break;
    case 256:
      err = launch_stage1_dq<256>(q, kf, vf, dxs, dq, stats, B, S, S4, F, N, C, heads, scale, st);
      break;
    case 448:  // the chunked form, two chunks of 224 keys
      err = launch_stage1_dq<448>(q, kf, vf, dxs, dq, stats, B, S, S4, F, N, C, heads, scale, st);
      break;
    default:   // the chunked form, two chunks of 256 keys
      err = launch_stage1_dq<512>(q, kf, vf, dxs, dq, stats, B, S, S4, F, N, C, heads, scale, st);
  }
  if (err != cudaSuccess) return err;
  return launch_stage1_dkdv(q, kf, vf, dxs, stats, dkf, dvf, B, S, S4, F, N,
                            C, heads, scale, st);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Inputs (bf16, contiguous): q [B, S, C]; kf, vf [B, F, N, C]; wq2, wk2
// [C, C] ([in, out]); dout [B, S, C]; the forward's xs [B, S, F, C] and q2
// [B, S, C]. Outputs: dq [B, S, C], dkf, dvf [B, F, N, C] in bf16; dwq2,
// dwk2 [C, C] and dbq2 [C] in float32. Scratch: a2, dl2 float32 [B S,
// heads, F]; dxs bf16 [B, S, F, C]; dq2 float32 and dq2b bf16 [B S, C]; dd
// float32 [B S, C]; part float32 [16, C, C]; wpart float32 [5, C, C];
// bpart float32 [2 ceil(B S / 32), C]; stats float32 [2, B, heads, F, S4]
// with S4 = S rounded up to 4. S = F * N (a window of query frames:
// traj_core_bwd_window_bf16 below), C = heads * 64 (a multiple of
// 128, at most 768: the stage-2 tiles' shared memory), F <= 8, N <= 512
// (past 256 the dq kernel's chunked form).
// Launches on ``stream``, stores the number of device kernels launched in
// *launched, and returns the first cudaError_t met.
namespace {

int backward_entry(
    const void* q, const void* kf, const void* vf, const void* wq2,
    const void* wk2, const void* dout, const void* xs, const void* q2,
    void* dq, void* dkf, void* dvf, void* dwq2, void* dbq2, void* dwk2,
    void* a2, void* dl2, void* dxs, void* dq2, void* dq2b, void* dd,
    void* part, void* wpart, void* bpart, void* stats, int* launched, int B,
    int S, int F, int N, int C, int heads, int f0, float scale, void* stream) {
  launches = 0;
  *launched = 0;
  if (B <= 0 || N <= 0 || N > MAX_KEYS || F <= 0 || F > MAX_F || S <= 0 ||
      S % N != 0 || f0 < 0 || f0 + S / N > F ||
      heads <= 0 || heads > MAX_HEADS || C != heads * HD || C % GN != 0 ||
      C > 768)
    return (int)cudaErrorInvalidValue;
  const void* tma_ptrs[] = {q, kf, vf, dxs, stats};
  for (const void* p : tma_ptrs)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  const int err = backward(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kf),
      static_cast<const bf16*>(vf), static_cast<const bf16*>(wq2),
      static_cast<const bf16*>(wk2), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(xs), static_cast<const bf16*>(q2),
      static_cast<bf16*>(dq), static_cast<bf16*>(dkf), static_cast<bf16*>(dvf),
      static_cast<float*>(dwq2), static_cast<float*>(dbq2),
      static_cast<float*>(dwk2), static_cast<float*>(a2),
      static_cast<float*>(dl2), static_cast<bf16*>(dxs),
      static_cast<float*>(dq2), static_cast<bf16*>(dq2b),
      static_cast<float*>(dd), static_cast<float*>(part),
      static_cast<float*>(wpart), static_cast<float*>(bpart),
      static_cast<float*>(stats), B, S, F, N, C, heads, scale,
      static_cast<cudaStream_t>(stream), f0);
  *launched = launches;
  return err;
}

}  // namespace

extern "C" int traj_core_bwd_bf16(
    const void* q, const void* kf, const void* vf, const void* wq2,
    const void* wk2, const void* dout, const void* xs, const void* q2,
    void* dq, void* dkf, void* dvf, void* dwq2, void* dbq2, void* dwk2,
    void* a2, void* dl2, void* dxs, void* dq2, void* dq2b, void* dd,
    void* part, void* wpart, void* bpart, void* stats, int* launched, int B,
    int S, int F, int N, int C, int heads, float scale, void* stream) {
  if (S != F * N) {
    *launched = 0;
    return (int)cudaErrorInvalidValue;
  }
  return backward_entry(q, kf, vf, wq2, wk2, dout, xs, q2, dq, dkf, dvf, dwq2,
                        dbq2, dwk2, a2, dl2, dxs, dq2, dq2b, dd, part, wpart,
                        bpart, stats, launched, B, S, F, N, C, heads, 0, scale,
                        stream);
}

// The backward over a window of query frames (sequence parallelism): q,
// dout, xs, q2 and dq hold the rows of frames [f0, f0 + S / N) (S a
// multiple of N, f0 + S / N <= F), kf, vf, dkf and dvf all F frames. dq is
// those rows' of the whole launch's; dkf, dvf, dwq2, dbq2 and dwk2 are the
// window's partial sums, which the caller sums over the windows. Otherwise
// as traj_core_bwd_bf16.
extern "C" int traj_core_bwd_window_bf16(
    const void* q, const void* kf, const void* vf, const void* wq2,
    const void* wk2, const void* dout, const void* xs, const void* q2,
    void* dq, void* dkf, void* dvf, void* dwq2, void* dbq2, void* dwk2,
    void* a2, void* dl2, void* dxs, void* dq2, void* dq2b, void* dd,
    void* part, void* wpart, void* bpart, void* stats, int* launched, int B,
    int S, int F, int N, int C, int heads, int f0, float scale,
    void* stream) {
  return backward_entry(q, kf, vf, wq2, wk2, dout, xs, q2, dq, dkf, dvf, dwq2,
                        dbq2, dwk2, a2, dl2, dxs, dq2, dq2b, dd, part, wpart,
                        bpart, stats, launched, B, S, F, N, C, heads, f0,
                        scale, stream);
}
