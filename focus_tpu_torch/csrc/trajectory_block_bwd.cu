// Backward of the fused trajectory-attention core for Hopper (sm_90a).
//
// Replaces the TPU kernel focus_tpu/ops/pallas/trajectory_block.py
// (_fused_bwd_kernel, called through _fused_bwd_pallas / _fused_bwd). It
// computes the gradients that jax.vjp of _xla_reference gives for q, kf, vf,
// Wq2, bq2 and Wk2 (the k2 bias has none), from the forward's inputs, the
// output gradient dout, and two residuals the forward kernel already writes
// to device memory: the stage-1 aggregates xs [B, S, F, C] and q2 [B, S, C].
//
// Stage 2 is rewritten so that every product is a plain GEMM. With
// Y = xs . Wk2 (rows m * F + f, all heads at once), the stage-2 logits are
// l2[m, h, f] = scale * q2[m, h] . Y[m, f, h] (the TPU kernel's
// g_h = q2_h . Wk2_h^T dotted with xs[f], reassociated), and with
// dl2 = scale * a2 * (da2 - sum_f a2 da2) and P[m, f, h] = dl2[m, h, f] q2[m, h]:
//   dq2[m, h]  = sum_f dl2[m, h, f] Y[m, f, h]
//   dxs[m, f]  = P[m, f] . Wk2^T + a2[m, h(c), f] dout[m, c]
//                + [f == own frame] (dq2 . Wq2^T)[m]
//   dWk2       = xs^T . P   (over all M * F rows)
//   dWq2       = x_diag^T . dq2,  dbq2 = sum_m dq2
// Stage 1 follows the FlashAttention-2 backward: the keys of a frame (N <= 256)
// fit one tile, so per (batch, head, 128 queries) a block recomputes the true
// max-subtracted softmax P over a frame's keys, takes r = sum_n P dP, forms
// dS = P (dP - r) and accumulates dq over the F frames in registers, writing
// the row statistics (max, 1 / sum, r); a second kernel per (batch, head,
// frame, 64 keys) loops over the queries with those statistics and
// accumulates dk and dv in registers. P, r and dS stay in float32, and dS
// enters the tensor cores as a pair of bf16 values (its rounding and the
// rest), because dq = sum_n dS k_n cancels: sum_n dS = 0, so where a frame's
// keys are nearly equal dq is a small difference of large terms, which bf16
// P or dS (2^-9) would swamp. No atomics: every sum across blocks (the
// split-K weight gradients, dbq2) is a second pass in a fixed order, so the
// result is deterministic.
//
// Launches, all on the caller's stream behind one C call: Y GEMM; the
// stage-2 row kernel; dq2 . Wq2^T; the dxs GEMM with its epilogue; dWk2 and
// dWq2 as split-K GEMMs each followed by a fixed-order sum; the dbq2 column
// sum and its sum; the stage-1 dq kernel; the stage-1 dk/dv kernel. 12 in all,
// counted into *launched.
//
// Rounding points: Y, dq2 (float32 copy), dd, the stage-1 weights P, r, dS
// and every accumulator stay in float32; P (stage 2), dq2 (GEMM copy) and
// dxs are rounded to bf16 as operands of mma.sync m16n8k16 (bf16 in, float32
// accumulate), as are the stage-1 weights for dv; dS is split into two bf16
// operands.
//
// Bound on this card: at B = 8, S = 1568, N = 196 the backward needs ~231
// GFLOP in the TPU kernel's form (five stage-1 products of 2 B S F N C, five
// C x C products of 2 B S C^2, three small stage-2 contractions) against
// ~0.3 GB of inputs and outputs: bound by operations (0.23 ms at the bf16
// peak). This first version spends ~3.5x those operations on stage 2 (the
// three xs-sized GEMMs of the rewrite) to keep each launch a plain GEMM, and
// keeps Y (float32), P and dxs ([B, S, F, C] each) in device memory; keeping
// them on chip with wgmma and TMA is later work.

#include "mma_sm90.cuh"

namespace {

constexpr int HD = 64;           // head dim
constexpr int LDH = HD + 8;      // bf16 stride of 64-wide tiles (144 bytes)
constexpr int MAX_NP = 256;      // keys per frame after padding to 16
constexpr int MAX_F = 8;
constexpr int MAX_HEADS = 16;
constexpr int SPLITS = 16;       // split-K depth of the weight gradients

thread_local int launches = 0;   // device kernels of the current call

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

enum Epilogue { EPI_F32 = 0, EPI_DXS = 1 };

struct GemmArgs {
  const bf16* a;
  const bf16* b;
  int M, N, K, lda, ldb;
  int k_chunk;                  // K per blockIdx.z, a multiple of GK
  int gather, S, Nk, F;         // AT: stored row k at (k F + (k % S) / Nk) lda
  float* out;                   // EPI_F32: out[z * out_z + row * N + col]
  size_t out_z;
  bf16* dxs;                    // EPI_DXS, rows m * F + f, N = C:
  const float* a2;              //   + a2[m, col / 64, f] * dout[m, col]
  const bf16* dout;             //   + dd[m, col] on the own frame
  const float* dd;
  int heads;
};

template <bool AT, bool BT, int EPI>
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
        float v0 = acc[i][j][2 * hi], v1 = acc[i][j][2 * hi + 1];
        if (EPI == EPI_F32) {
          *reinterpret_cast<float2*>(p.out + blockIdx.z * p.out_z +
                                     (size_t)row * p.N + col) =
              make_float2(v0, v1);
        } else {
          const int m = row / p.F, f = row % p.F;
          const float a = p.a2[((size_t)m * p.heads + col / HD) * p.F + f];
          const float2 d = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.dout + (size_t)m * p.N + col));
          v0 = fmaf(a, d.x, v0);
          v1 = fmaf(a, d.y, v1);
          if (f == (m % p.S) / p.Nk) {
            const float2 e =
                *reinterpret_cast<const float2*>(p.dd + (size_t)m * p.N + col);
            v0 += e.x;
            v1 += e.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(p.dxs + (size_t)row * p.N + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <bool AT, bool BT, int EPI>
cudaError_t gemm(const GemmArgs& p, int splits, cudaStream_t st) {
  const dim3 grid((p.N + GN - 1) / GN, (p.M + GM - 1) / GM, splits);
  gemm_kernel<AT, BT, EPI><<<grid, G_THREADS, 0, st>>>(p);
  ++launches;
  return cudaGetLastError();
}

// split-K chunk: ceil(K / SPLITS) rounded up to GK
inline int split_chunk(int K) {
  return (int)round_up((size_t)(K + SPLITS - 1) / SPLITS, GK);
}

// out[i] = sum_z part[z * n + i], z in order (n % 4 == 0)
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int n, int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n / 4;
       i += gridDim.x * blockDim.x) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int z = 0; z < splits; ++z) {
      const float4 v = reinterpret_cast<const float4*>(part + (size_t)z * n)[i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(out)[i] = s;
  }
}

cudaError_t sum_splits(const float* part, float* out, int n, cudaStream_t st) {
  const int blocks = min((n / 4 + 255) / 256, 1024);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(part, out, n, SPLITS);
  ++launches;
  return cudaGetLastError();
}

// part[z, c] = sum of x[m, c] over row chunk z; 32 columns x 8 row lanes
__global__ void __launch_bounds__(256) colsum_kernel(
    const float* __restrict__ x, float* __restrict__ part, int M, int C,
    int rows) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  const int r0 = blockIdx.y * rows, r1 = min(M, r0 + rows);
  float s = 0.0f;
  if (c < C)
    for (int r = r0 + ty; r < r1; r += 8) s += x[(size_t)r * C + c];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < C) {
    for (int k = 1; k < 8; ++k) s += red[k][tx];
    part[(size_t)blockIdx.y * C + c] = s;
  }
}

// ---- stage 2, per row ----------------------------------------------------
// One block per flattened row m = b * S + s, one warp per head; a lane owns
// two of the head's 64 channels. Reads Y, xs, q2 and dout; writes a2, dq2
// (float32 and a bf16 copy for the GEMMs) and P.

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void stage2_rows_kernel(
    const bf16* __restrict__ xs, const bf16* __restrict__ q2,
    const float* __restrict__ y, const bf16* __restrict__ dout,
    float* __restrict__ a2o, float* __restrict__ dq2, bf16* __restrict__ dq2b,
    bf16* __restrict__ pmat, int F, int C, int heads, float scale) {
  const int m = blockIdx.x, h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (h >= heads) return;
  const int c = h * HD + 2 * lane;
  const float2 qv = ld_bf16x2(q2 + (size_t)m * C + c);
  const float2 dv = ld_bf16x2(dout + (size_t)m * C + c);
  float2 yv[MAX_F];
  float l[MAX_F], da[MAX_F];
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) {
    yv[f] = make_float2(0.0f, 0.0f);
    l[f] = da[f] = 0.0f;
    if (f < F) {
      const size_t r = ((size_t)m * F + f) * C + c;
      yv[f] = *reinterpret_cast<const float2*>(y + r);
      const float2 xv = ld_bf16x2(xs + r);
      l[f] = warp_sum(qv.x * yv[f].x + qv.y * yv[f].y) * scale;
      da[f] = warp_sum(dv.x * xv.x + dv.y * xv.y);
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int f = 0; f < MAX_F; ++f)
    if (f < F) mx = fmaxf(mx, l[f]);
  float sum = 0.0f;
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) {
    l[f] = f < F ? expf(l[f] - mx) : 0.0f;
    sum += l[f];
  }
  float r2 = 0.0f;
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) {
    l[f] /= sum;  // a2
    r2 += l[f] * da[f];
  }
  float2 dq = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) {
    if (f >= F) break;
    const float dl = scale * l[f] * (da[f] - r2);
    dq.x = fmaf(dl, yv[f].x, dq.x);
    dq.y = fmaf(dl, yv[f].y, dq.y);
    *reinterpret_cast<__nv_bfloat162*>(pmat + ((size_t)m * F + f) * C + c) =
        __floats2bfloat162_rn(dl * qv.x, dl * qv.y);
    if (lane == f) a2o[((size_t)m * heads + h) * F + f] = l[f];
  }
  *reinterpret_cast<float2*>(dq2 + (size_t)m * C + c) = dq;
  *reinterpret_cast<__nv_bfloat162*>(dq2b + (size_t)m * C + c) =
      __floats2bfloat162_rn(dq.x, dq.y);
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

// ---- stage 1, dq ---------------------------------------------------------
// One block per batch row, head and 128 queries (8 warps of 16 rows), looping
// over the frames as the forward's stage 1 does, with the same shared-memory
// plan (double-buffered K and V tiles of the frame's keys, the first K buffer
// staging the Q tile). Per frame a warp recomputes its rows' logits over all
// keys in registers and the max-subtracted softmax P (float32, kept there),
// then in a first pass over the key tiles dP = dO V^T and r = sum_n P dP, in
// a second dP again, dS = P (dP - r) and dq += dS K. Writes dq and the
// statistics stats[{max, 1 / sum, r}][b][head][f][s] for the dk/dv kernel.

constexpr int S1_ROWS = 128;
constexpr int S1_THREADS = 256;

template <int KT>
__host__ __device__ constexpr int stage1_krows() {
  return 16 * KT > S1_ROWS ? 16 * KT : S1_ROWS;
}

template <int KT>
constexpr size_t stage1_smem() {
  return (size_t)(stage1_krows<KT>() + 3 * 16 * KT) * LDH * sizeof(bf16);
}

template <int KT>
__global__ void __launch_bounds__(S1_THREADS) stage1_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kf,
    const bf16* __restrict__ vf, const bf16* __restrict__ dxs,
    bf16* __restrict__ dq, float* __restrict__ stats, int S, int F, int N,
    int C, int heads, float scale) {
  constexpr int NP = 16 * KT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* K0 = reinterpret_cast<bf16*>(smem);
  bf16* V0 = K0 + stage1_krows<KT>() * LDH;
  bf16* K1 = V0 + NP * LDH;
  bf16* V1 = K1 + NP * LDH;

  const int s0 = blockIdx.x * S1_ROWS, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hoff = head * HD;

  for (int i = tid; i < S1_ROWS * 8; i += S1_THREADS) {
    const int r = i >> 3, c8 = (i & 7) * 8, s = s0 + r;
    bf16* dst = K0 + r * LDH + c8;
    if (s < S) copy16(dst, q + ((size_t)b * S + s) * C + hoff + c8);
    else zero16(dst);
  }
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    ldmatrix_x4(qa[ks], K0 + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDH +
                            ks * 16 + 8 * (lane >> 4));
  __syncthreads();
  for (int i = tid; i < (NP - N) * 8; i += S1_THREADS) {
    const int r = N + (i >> 3), c8 = (i & 7) * 8;
    zero16(K0 + r * LDH + c8);
    zero16(V0 + r * LDH + c8);
    zero16(K1 + r * LDH + c8);
    zero16(V1 + r * LDH + c8);
  }
  auto issue_frame = [&](int f) {
    const size_t kv0 = ((size_t)b * F + f) * N * C + hoff;
    bf16* Kd = (f & 1) ? K1 : K0;
    bf16* Vd = (f & 1) ? V1 : V0;
    for (int i = tid; i < N * 8; i += S1_THREADS) {
      const int r = i >> 3, c8 = (i & 7) * 8;
      cp_async16(Kd + r * LDH + c8, kf + kv0 + (size_t)r * C + c8);
      cp_async16(Vd + r * LDH + c8, vf + kv0 + (size_t)r * C + c8);
    }
    cp_async_commit();
  };
  issue_frame(0);

  const int row0 = s0 + warp * 16 + g, row1 = row0 + 8;
  const size_t plane = (size_t)gridDim.z * heads * F * S;
  float dqacc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[n][e] = 0.0f;

  for (int f = 0; f < F; ++f) {
    if (f + 1 < F) {
      issue_frame(f + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = (f & 1) ? K1 : K0;
    const bf16* Vs = (f & 1) ? V1 : V0;

    // logits, tile n: keys 8n + 2t + {0, 1} of rows g (0, 1) and g + 8 (2, 3)
    float sacc[2 * KT][4];
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Ks + (j * 16 + (lane & 7) + 8 * (lane >> 4)) * LDH +
                            ks * 16 + 8 * ((lane >> 3) & 1));
        mma_16816(sacc[2 * j], qa[ks], kb[0], kb[1]);
        mma_16816(sacc[2 * j + 1], qa[ks], kb[2], kb[3]);
      }
    }
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * t + (e & 1);
        const float v = key < N ? sacc[n][e] * scale : -INFINITY;
        sacc[n][e] = v;
        if (e < 2) m0 = fmaxf(m0, v);
        else m1 = fmaxf(m1, v);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * t + (e & 1);
        const float p = key < N ? __expf(sacc[n][e] - (e < 2 ? m0 : m1)) : 0.0f;
        sacc[n][e] = p;
        if (e < 2) l0 += p;
        else l1 += p;
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n) {
      sacc[n][0] *= inv0;
      sacc[n][1] *= inv0;
      sacc[n][2] *= inv1;
      sacc[n][3] *= inv1;
    }

    // dO = dxs[b, s, f, head] as A fragments
    uint32_t da[HD / 16][4];
    {
      const bf16* d0 = dxs + (((size_t)b * S + row0) * F + f) * C + hoff + 2 * t;
      const bf16* d1 = dxs + (((size_t)b * S + row1) * F + f) * C + hoff + 2 * t;
      const bool ok0 = row0 < S, ok1 = row1 < S;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        da[ks][0] = ok0 ? ldg32(d0 + ks * 16) : 0u;
        da[ks][1] = ok1 ? ldg32(d1 + ks * 16) : 0u;
        da[ks][2] = ok0 ? ldg32(d0 + ks * 16 + 8) : 0u;
        da[ks][3] = ok1 ? ldg32(d1 + ks * 16 + 8) : 0u;
      }
    }
    // dP of key tile j: tile 0 keys 16 j + 2t + {0, 1}, tile 1 keys + 8
    auto dp_tile = [&](int j, float (&dpa)[2][4]) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpa[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t vb[4];
        ldmatrix_x4(vb, Vs + (j * 16 + (lane & 7) + 8 * (lane >> 4)) * LDH +
                            ks * 16 + 8 * ((lane >> 3) & 1));
        mma_16816(dpa[0], da[ks], vb[0], vb[1]);
        mma_16816(dpa[1], da[ks], vb[2], vb[3]);
      }
    };

    // pass 1: r = sum_n P dP
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float dpa[2][4];
      dp_tile(j, dpa);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        r0 += sacc[2 * j + h][0] * dpa[h][0] + sacc[2 * j + h][1] * dpa[h][1];
        r1 += sacc[2 * j + h][2] * dpa[h][2] + sacc[2 * j + h][3] * dpa[h][3];
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      r0 += __shfl_xor_sync(0xffffffffu, r0, o);
      r1 += __shfl_xor_sync(0xffffffffu, r1, o);
    }
    if (t == 0) {
      float* st = stats + (((size_t)b * heads + head) * F + f) * S;
      if (row0 < S) {
        st[row0] = m0;
        st[plane + row0] = inv0;
        st[2 * plane + row0] = r0;
      }
      if (row1 < S) {
        st[row1] = m1;
        st[plane + row1] = inv1;
        st[2 * plane + row1] = r1;
      }
    }

    // pass 2: dS = P (dP - r) as hi + lo A fragments, dq += dS K
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float dpa[2][4];
      dp_tile(j, dpa);
      uint32_t dsh[4], dsl[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        split_bf16x2(sacc[2 * j + h][0] * (dpa[h][0] - r0),
                     sacc[2 * j + h][1] * (dpa[h][1] - r0), dsh[2 * h],
                     dsl[2 * h]);
        split_bf16x2(sacc[2 * j + h][2] * (dpa[h][2] - r1),
                     sacc[2 * j + h][3] * (dpa[h][3] - r1), dsh[2 * h + 1],
                     dsl[2 * h + 1]);
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, Ks + (j * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                       LDH + dp * 16 + 8 * (lane >> 4));
        mma_16816(dqacc[2 * dp], dsh, kb[0], kb[1]);
        mma_16816(dqacc[2 * dp], dsl, kb[0], kb[1]);
        mma_16816(dqacc[2 * dp + 1], dsh, kb[2], kb[3]);
        mma_16816(dqacc[2 * dp + 1], dsl, kb[2], kb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copy
  }

  bf16* out0 = dq + ((size_t)b * S + row0) * C + hoff + 2 * t;
  bf16* out1 = dq + ((size_t)b * S + row1) * C + hoff + 2 * t;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out0 + n * 8) =
          __floats2bfloat162_rn(scale * dqacc[n][0], scale * dqacc[n][1]);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out1 + n * 8) =
          __floats2bfloat162_rn(scale * dqacc[n][2], scale * dqacc[n][3]);
  }
}

template <int KT>
cudaError_t launch_stage1_dq(const bf16* q, const bf16* kf, const bf16* vf,
                             const bf16* dxs, bf16* dq, float* stats, int B,
                             int S, int F, int N, int C, int heads, float scale,
                             cudaStream_t st) {
  constexpr size_t smem = stage1_smem<KT>();
  cudaError_t err = cudaFuncSetAttribute(
      stage1_dq_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + S1_ROWS - 1) / S1_ROWS, heads, B);
  stage1_dq_kernel<KT><<<grid, S1_THREADS, smem, st>>>(
      q, kf, vf, dxs, dq, stats, S, F, N, C, heads, scale);
  ++launches;
  return cudaGetLastError();
}

// ---- stage 1, dk and dv --------------------------------------------------
// One block per batch row, head, frame and 64 keys (4 warps of 16 keys). A
// warp keeps its keys' K and V rows as A fragments and loops over the
// queries in chunks of 64 (Q and dO chunks and their statistics copied in one
// chunk ahead): S^T = K Q^T and dP^T = V dO^T, P^T = exp(scale S^T - max)
// / sum and dS^T = P^T (dP^T - r) in float32, then dv += P^T dO (P^T in bf16)
// and dk += dS^T Q (dS^T as hi + lo), accumulated in registers over all
// queries.

constexpr int KV_KEYS = 64;
constexpr int KV_THREADS = 128;
constexpr int QC = 64;  // queries per chunk

__global__ void __launch_bounds__(KV_THREADS) stage1_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kf,
    const bf16* __restrict__ vf, const bf16* __restrict__ dxs,
    const float* __restrict__ stats, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int F, int N, int C, int heads,
    float scale) {
  __shared__ __align__(128) bf16 Qs[2][QC * LDH];
  __shared__ __align__(128) bf16 Ds[2][QC * LDH];
  __shared__ float St[2][3][QC];
  const int n0 = blockIdx.x * KV_KEYS;
  const int head = blockIdx.y / F, f = blockIdx.y % F, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hoff = head * HD;

  // this block's K and V rows, staged through the first chunk buffers
  for (int i = tid; i < KV_KEYS * 8; i += KV_THREADS) {
    const int r = i >> 3, c8 = (i & 7) * 8, n = n0 + r;
    const size_t src = (((size_t)b * F + f) * N + n) * C + hoff + c8;
    if (n < N) {
      copy16(Qs[0] + r * LDH + c8, kf + src);
      copy16(Ds[0] + r * LDH + c8, vf + src);
    } else {
      zero16(Qs[0] + r * LDH + c8);
      zero16(Ds[0] + r * LDH + c8);
    }
  }
  __syncthreads();
  uint32_t ka[HD / 16][4], va[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int off = (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDH +
                    ks * 16 + 8 * (lane >> 4);
    ldmatrix_x4(ka[ks], Qs[0] + off);
    ldmatrix_x4(va[ks], Ds[0] + off);
  }
  __syncthreads();

  const size_t plane = (size_t)gridDim.z * heads * F * S;
  const float* stm = stats + (((size_t)b * heads + head) * F + f) * S;
  auto issue = [&](int chunk, int stage) {
    const int s0 = chunk * QC;
    for (int i = tid; i < QC * 8; i += KV_THREADS) {
      const int r = i >> 3, c8 = (i & 7) * 8, s = s0 + r;
      bf16* qd = Qs[stage] + r * LDH + c8;
      bf16* dd = Ds[stage] + r * LDH + c8;
      if (s < S) {
        cp_async16(qd, q + ((size_t)b * S + s) * C + hoff + c8);
        cp_async16(dd, dxs + (((size_t)b * S + s) * F + f) * C + hoff + c8);
      } else {
        zero16(qd);
        zero16(dd);
      }
    }
    // a query past S gets weight 0 (1 / sum = 0)
    for (int i = tid; i < QC; i += KV_THREADS) {
      const int s = s0 + i;
      St[stage][0][i] = s < S ? stm[s] : 0.0f;
      St[stage][1][i] = s < S ? stm[plane + s] : 0.0f;
      St[stage][2][i] = s < S ? stm[2 * plane + s] : 0.0f;
    }
    cp_async_commit();
  };

  float dkacc[HD / 8][4], dvacc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[n][e] = dvacc[n][e] = 0.0f;

  const int nchunks = (S + QC - 1) / QC;
  issue(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      issue(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qc = Qs[c & 1];
    const bf16* Dc = Ds[c & 1];
    const float* smax = St[c & 1][0];
    const float* sinv = St[c & 1][1];
    const float* sr = St[c & 1][2];

    // S^T and dP^T, tile n: queries 8n + 2t + {0, 1} of keys g (0, 1) and
    // g + 8 (2, 3)
    float sacc[QC / 8][4], dpacc[QC / 8][4];
#pragma unroll
    for (int n = 0; n < QC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = dpacc[n][e] = 0.0f;
#pragma unroll
    for (int qb = 0; qb < QC / 16; ++qb) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int off = (qb * 16 + (lane & 7) + 8 * (lane >> 4)) * LDH + ks * 16 +
                        8 * ((lane >> 3) & 1);
        uint32_t bq[4], bd[4];
        ldmatrix_x4(bq, Qc + off);
        ldmatrix_x4(bd, Dc + off);
        mma_16816(sacc[2 * qb], ka[ks], bq[0], bq[1]);
        mma_16816(sacc[2 * qb + 1], ka[ks], bq[2], bq[3]);
        mma_16816(dpacc[2 * qb], va[ks], bd[0], bd[1]);
        mma_16816(dpacc[2 * qb + 1], va[ks], bd[2], bd[3]);
      }
    }
    // P^T (bf16) and dS^T (hi + lo) as A fragments over the query dimension
    uint32_t pa[QC / 16][4], dsh[QC / 16][4], dsl[QC / 16][4];
#pragma unroll
    for (int kb = 0; kb < QC / 16; ++kb) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kb + half;
        const int qi = 8 * n + 2 * t;
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = qi + (e & 1);
          p[e] = __expf(sacc[n][e] * scale - smax[qq]) * sinv[qq];
          ds[e] = p[e] * (dpacc[n][e] - sr[qq]);
        }
        pa[kb][2 * half] = pack_bf16x2(p[0], p[1]);
        pa[kb][2 * half + 1] = pack_bf16x2(p[2], p[3]);
        split_bf16x2(ds[0], ds[1], dsh[kb][2 * half], dsl[kb][2 * half]);
        split_bf16x2(ds[2], ds[3], dsh[kb][2 * half + 1], dsl[kb][2 * half + 1]);
      }
    }
    // dv += P^T dO, dk += dS^T Q (B operands stored [query][dim])
#pragma unroll
    for (int kb = 0; kb < QC / 16; ++kb) {
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        const int off = (kb * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDH +
                        dp * 16 + 8 * (lane >> 4);
        uint32_t bd[4], bq[4];
        ldmatrix_x4_trans(bd, Dc + off);
        ldmatrix_x4_trans(bq, Qc + off);
        mma_16816(dvacc[2 * dp], pa[kb], bd[0], bd[1]);
        mma_16816(dvacc[2 * dp + 1], pa[kb], bd[2], bd[3]);
        mma_16816(dkacc[2 * dp], dsh[kb], bq[0], bq[1]);
        mma_16816(dkacc[2 * dp], dsl[kb], bq[0], bq[1]);
        mma_16816(dkacc[2 * dp + 1], dsh[kb], bq[2], bq[3]);
        mma_16816(dkacc[2 * dp + 1], dsl[kb], bq[2], bq[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copy
  }

  const int key0 = n0 + warp * 16 + g, key1 = key0 + 8;
  const size_t base = ((size_t)b * F + f) * N;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = hoff + n * 8 + 2 * t;
    if (key0 < N) {
      *reinterpret_cast<__nv_bfloat162*>(dk + (base + key0) * C + col) =
          __floats2bfloat162_rn(scale * dkacc[n][0], scale * dkacc[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + (base + key0) * C + col) =
          __floats2bfloat162_rn(dvacc[n][0], dvacc[n][1]);
    }
    if (key1 < N) {
      *reinterpret_cast<__nv_bfloat162*>(dk + (base + key1) * C + col) =
          __floats2bfloat162_rn(scale * dkacc[n][2], scale * dkacc[n][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + (base + key1) * C + col) =
          __floats2bfloat162_rn(dvacc[n][2], dvacc[n][3]);
    }
  }
}

int backward(const bf16* q, const bf16* kf, const bf16* vf, const bf16* wq2,
             const bf16* wk2, const bf16* dout, const bf16* xs, const bf16* q2,
             bf16* dq, bf16* dkf, bf16* dvf, float* dwq2, float* dbq2,
             float* dwk2, float* y, bf16* pmat, bf16* dxs, float* a2,
             float* dq2, bf16* dq2b, float* dd, float* part, float* stats,
             int B, int S, int F, int N, int C, int heads, float scale,
             cudaStream_t st) {
  cudaError_t err;
  const int M = B * S, MF = M * F;

  // Y = xs . Wk2 (float32)
  GemmArgs ga = {};
  ga.a = xs; ga.lda = C; ga.b = wk2; ga.ldb = C;
  ga.M = MF; ga.N = C; ga.K = C; ga.k_chunk = C;
  ga.out = y;
  if ((err = gemm<false, false, EPI_F32>(ga, 1, st)) != cudaSuccess) return err;

  stage2_rows_kernel<<<M, heads * 32, 0, st>>>(xs, q2, y, dout, a2, dq2, dq2b,
                                               pmat, F, C, heads, scale);
  ++launches;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // dd = dq2 . Wq2^T (float32)
  GemmArgs gd = {};
  gd.a = dq2b; gd.lda = C; gd.b = wq2; gd.ldb = C;
  gd.M = M; gd.N = C; gd.K = C; gd.k_chunk = C;
  gd.out = dd;
  if ((err = gemm<false, true, EPI_F32>(gd, 1, st)) != cudaSuccess) return err;

  // dxs = P . Wk2^T + value term + own-frame term (bf16)
  GemmArgs gx = {};
  gx.a = pmat; gx.lda = C; gx.b = wk2; gx.ldb = C;
  gx.M = MF; gx.N = C; gx.K = C; gx.k_chunk = C;
  gx.S = S; gx.Nk = N; gx.F = F;
  gx.dxs = dxs; gx.a2 = a2; gx.dout = dout; gx.dd = dd; gx.heads = heads;
  if ((err = gemm<false, true, EPI_DXS>(gx, 1, st)) != cudaSuccess) return err;

  // dWk2 = xs^T . P over the M * F rows, split-K
  GemmArgs gk = {};
  gk.a = xs; gk.lda = C; gk.b = pmat; gk.ldb = C;
  gk.M = C; gk.N = C; gk.K = MF; gk.k_chunk = split_chunk(MF);
  gk.out = part; gk.out_z = (size_t)C * C;
  if ((err = gemm<true, false, EPI_F32>(gk, SPLITS, st)) != cudaSuccess) return err;
  if ((err = sum_splits(part, dwk2, C * C, st)) != cudaSuccess) return err;

  // dWq2 = x_diag^T . dq2 over the M rows (own-frame rows of xs), split-K
  GemmArgs gq = {};
  gq.a = xs; gq.lda = C; gq.gather = 1; gq.S = S; gq.Nk = N; gq.F = F;
  gq.b = dq2b; gq.ldb = C;
  gq.M = C; gq.N = C; gq.K = M; gq.k_chunk = split_chunk(M);
  gq.out = part; gq.out_z = (size_t)C * C;
  if ((err = gemm<true, false, EPI_F32>(gq, SPLITS, st)) != cudaSuccess) return err;
  if ((err = sum_splits(part, dwq2, C * C, st)) != cudaSuccess) return err;

  // dbq2 = sum over rows of dq2 (float32)
  const int rows = (M + SPLITS - 1) / SPLITS;
  colsum_kernel<<<dim3((C + 31) / 32, SPLITS), 256, 0, st>>>(dq2, part, M, C,
                                                             rows);
  ++launches;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sum_splits(part, dbq2, C, st)) != cudaSuccess) return err;

  // stage 1: dq (and the row statistics), then dk and dv
  const int kt = (N + 15) / 16;
  if (kt <= 4)
    err = launch_stage1_dq<4>(q, kf, vf, dxs, dq, stats, B, S, F, N, C, heads, scale, st);
  else if (kt <= 8)
    err = launch_stage1_dq<8>(q, kf, vf, dxs, dq, stats, B, S, F, N, C, heads, scale, st);
  else if (kt <= 13)
    err = launch_stage1_dq<13>(q, kf, vf, dxs, dq, stats, B, S, F, N, C, heads, scale, st);
  else
    err = launch_stage1_dq<16>(q, kf, vf, dxs, dq, stats, B, S, F, N, C, heads, scale, st);
  if (err != cudaSuccess) return err;

  const dim3 gkv((N + KV_KEYS - 1) / KV_KEYS, heads * F, B);
  stage1_dkdv_kernel<<<gkv, KV_THREADS, 0, st>>>(q, kf, vf, dxs, stats, dkf,
                                                 dvf, S, F, N, C, heads, scale);
  ++launches;
  return cudaGetLastError();
}

}  // namespace

// Inputs (bf16, contiguous): q [B, S, C]; kf, vf [B, F, N, C]; wq2, wk2
// [C, C] ([in, out]); dout [B, S, C]; the forward's xs [B, S, F, C] and q2
// [B, S, C]. Outputs: dq [B, S, C], dkf, dvf [B, F, N, C] in bf16; dwq2,
// dwk2 [C, C] and dbq2 [C] in float32. Scratch: y float32 [B S F, C]; pmat,
// dxs bf16 [B S F, C]; a2 float32 [B S, heads, F]; dq2 float32 and dq2b bf16
// [B S, C]; dd float32 [B S, C]; part float32 [16, C, C]; stats float32
// [3, B, heads, F, S]. S = F * N, C = heads * 64 (a multiple of 128),
// F <= 8, N <= 256, heads <= 16. Launches on ``stream``, stores the number
// of device kernels launched in *launched, and returns the first
// cudaError_t met.
extern "C" int traj_core_bwd_bf16(
    const void* q, const void* kf, const void* vf, const void* wq2,
    const void* wk2, const void* dout, const void* xs, const void* q2,
    void* dq, void* dkf, void* dvf, void* dwq2, void* dbq2, void* dwk2,
    void* y, void* pmat, void* dxs, void* a2, void* dq2, void* dq2b, void* dd,
    void* part, void* stats, int* launched, int B, int S, int F, int N, int C,
    int heads, float scale, void* stream) {
  launches = 0;
  *launched = 0;
  if (B <= 0 || N <= 0 || N > MAX_NP || F <= 0 || F > MAX_F || S != F * N ||
      heads <= 0 || heads > MAX_HEADS || C != heads * HD || C % GN != 0)
    return (int)cudaErrorInvalidValue;
  const int err = backward(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kf),
      static_cast<const bf16*>(vf), static_cast<const bf16*>(wq2),
      static_cast<const bf16*>(wk2), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(xs), static_cast<const bf16*>(q2),
      static_cast<bf16*>(dq), static_cast<bf16*>(dkf), static_cast<bf16*>(dvf),
      static_cast<float*>(dwq2), static_cast<float*>(dbq2),
      static_cast<float*>(dwk2), static_cast<float*>(y),
      static_cast<bf16*>(pmat), static_cast<bf16*>(dxs),
      static_cast<float*>(a2), static_cast<float*>(dq2),
      static_cast<bf16*>(dq2b), static_cast<float*>(dd),
      static_cast<float*>(part), static_cast<float*>(stats), B, S, F, N, C,
      heads, scale, static_cast<cudaStream_t>(stream));
  *launched = launches;
  return err;
}
