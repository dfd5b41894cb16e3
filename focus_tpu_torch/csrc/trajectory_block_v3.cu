// Trajectory core, forward version 3, for Hopper (sm_90a), non-CLS tokens.
//
// Replaces the TPU kernel focus_tpu/ops/pallas/trajectory_block.py
// (_fused_kernel_v3, called through _fused_fwd_pallas under FWD_VERSION = 3
// with its KERNEL_FLAGS: nomax, diag_frame, fouter). The function of version
// 4 (trajectory_block.cu), in one launch per call: one block per batch row
// and query block of BQ = 128 rows runs stage 1 for every frame and head,
// then q2 and stage 2 for its own rows, as the TPU kernel's grid cell
// (b, query block) does with the frame innermost and stage 2 on the last
// frame step.
//
//   stage 1, frame outer and head inner: the frame's K / V head tiles and
//     the block's Q head tile are copied in (cp.async) one step ahead of use.
//     Each warp owns 16 query rows and keeps their logits for the whole
//     frame in registers (mma.sync m16n8k16, ldmatrix): p = exp(logit *
//     scale - max) with a true per-frame max, s = sum of p in float32, the
//     bf16 p as the A fragments of P . V, and xs_f = round(o / s) written to
//     xs [B, S, F, C]. The weights are rounded before they are normalised,
//     as the TPU kernel's nomax form rounds them (version 4 normalises
//     first); the true max replaces its clamped exp2 with no max.
//   q2 and stage 2 (trajectory_stage2.cuh, shared with version 7): after
//     the last frame and a __syncthreads() (the block's own writes to xs are
//     then visible to all its threads), q2 = x_diag . Wq2 + bq2 (unscaled
//     into q2 for the backward kernel, scaled and rounded into out), then
//     stage 2 in groups of 3 heads with g_h kept in float32 (the fouter
//     form), and out = round(sum_f a2_f xs_f).
//
// BQ = 128 and 8 warps: the shared memory a block needs (below) admits one
// block per SM whatever BQ is, so at B = 8, S = 1568 a BQ of 64 would give
// 200 blocks of 4 warps in two waves over the 132 SMs, where 128 gives 104
// blocks of 8 warps in one wave: 28 SMs idle, but each busy SM has twice
// the warps to hide the mma and exp latencies, for the same rows per warp.
//
// Shared memory, one buffer reused by the three phases (KT = keys per frame
// / 16 rounded up to an instantiated size, NP = 16 KT; 208 at N = 196, 200):
//   stage 1: two buffers of Q [128][72] + K [NP][72] + V [NP][72] bf16,
//            153 KB at NP = 208 (180 KB at NP = 256);
//   q2 and stage 2: stage2_smem(F), 201 KB at F = 8 (trajectory_stage2.cuh).
// The block takes the largest, 201 KB of the 227 KB a block may have.
//
// Bound on this card: version 4's function, 0.0930 ms at B = 8, S = 1568
// (operations, ~92 GFLOP against ~60 MB of inputs and outputs). This
// version, like version 4, moves xs [B, S, F, C] (~154 MB at B = 8) through
// device memory (the backward reads it), and every block re-reads its batch
// row's K and V (from L2 where its neighbours share them); keeping xs on
// chip with TMA, wgmma and clusters is later work.

#include "trajectory_stage2.cuh"

namespace {

constexpr int BQ = S2_ROWS;       // query rows per block (8 warps x 16)
constexpr int THREADS = S2_THREADS;

template <int KT>
__host__ __device__ constexpr size_t v3_stage1_elems() {  // one buffer
  return (size_t)(BQ + 2 * 16 * KT) * LDH;
}

template <int KT>
__host__ __device__ inline size_t v3_smem(int F) {
  const size_t s1 = 2 * v3_stage1_elems<KT>() * sizeof(bf16);
  const size_t s2 = stage2_smem(F);
  return s1 > s2 ? s1 : s2;
}

// xs, q2 and out are written and read back by the same block, so they are
// read with plain (coherent) loads, never through the read-only path
template <int KT>
__global__ void __launch_bounds__(THREADS, 1) traj_v3_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kf,
    const bf16* __restrict__ vf, const bf16* __restrict__ wq2,
    const bf16* __restrict__ bq2, const bf16* __restrict__ wk2, bf16* xs,
    bf16* q2, bf16* out, int S, int F, int N, int C, int heads, float scale) {
  constexpr int NP = 16 * KT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int s0 = blockIdx.x * BQ, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int rows = min(BQ, S - s0);       // valid query rows of the block
  const size_t row_base = (size_t)b * S + s0;

  // ---- stage 1 -------------------------------------------------------------
  {
    // buffer j: Q [BQ][LDH], K [NP][LDH], V [NP][LDH]
    auto buf = [&](int j) {
      return reinterpret_cast<bf16*>(smem) + j * v3_stage1_elems<KT>();
    };
    // query rows past S and key rows past N stay zero in both buffers
    for (int i = tid; i < (BQ - rows) * 8; i += THREADS) {
      const int r = rows + (i >> 3), c8 = (i & 7) * 8;
      zero16(buf(0) + r * LDH + c8);
      zero16(buf(1) + r * LDH + c8);
    }
    for (int i = tid; i < (NP - N) * 8; i += THREADS) {
      const int r = N + (i >> 3), c8 = (i & 7) * 8;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        zero16(buf(j) + (BQ + r) * LDH + c8);
        zero16(buf(j) + (BQ + NP + r) * LDH + c8);
      }
    }
    // step i: frame i / heads, head i % heads, into buffer i % 2
    auto copy_step = [&](int i) {
      const int f = i / heads, hoff = (i % heads) * HD;
      bf16* Qd = buf(i & 1);
      bf16* Kd = Qd + BQ * LDH;
      bf16* Vd = Kd + NP * LDH;
      for (int j = tid; j < rows * 8; j += THREADS) {
        const int r = j >> 3, c8 = (j & 7) * 8;
        cp_async16(Qd + r * LDH + c8, q + (row_base + r) * C + hoff + c8);
      }
      const size_t kv0 = ((size_t)b * F + f) * N * C + hoff;
      for (int j = tid; j < N * 8; j += THREADS) {
        const int r = j >> 3, c8 = (j & 7) * 8;
        cp_async16(Kd + r * LDH + c8, kf + kv0 + (size_t)r * C + c8);
        cp_async16(Vd + r * LDH + c8, vf + kv0 + (size_t)r * C + c8);
      }
      cp_async_commit();
    };
    copy_step(0);

    const int r0 = warp * 16 + g, r1 = r0 + 8;
    const int steps = F * heads;
    for (int i = 0; i < steps; ++i) {
      if (i + 1 < steps) {
        copy_step(i + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // step i's tiles have landed for every thread
      const int f = i / heads, hoff = (i % heads) * HD;
      const bf16* Qs = buf(i & 1);
      const bf16* Ks = Qs + BQ * LDH;
      const bf16* Vs = Ks + NP * LDH;

      uint32_t qa[HD / 16][4];
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        ldmatrix_x4(qa[ks], Qs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                     LDH + ks * 16 + 8 * (lane >> 4));

      // logits: tile n holds keys 8n + 2t + {0, 1} of rows g (elements 0, 1)
      // and g + 8 (2, 3)
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

      // p = exp(logit * scale - max) over the N valid keys, and its sums
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

      // o = round(p) . V, then xs = round(o / s)
      float oacc[HD / 8][4];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const uint32_t pa[4] = {
            pack_bf16x2(sacc[2 * j][0], sacc[2 * j][1]),
            pack_bf16x2(sacc[2 * j][2], sacc[2 * j][3]),
            pack_bf16x2(sacc[2 * j + 1][0], sacc[2 * j + 1][1]),
            pack_bf16x2(sacc[2 * j + 1][2], sacc[2 * j + 1][3])};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, Vs + (j * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                         LDH + dp * 16 + 8 * (lane >> 4));
          mma_16816(oacc[2 * dp], pa, vb[0], vb[1]);
          mma_16816(oacc[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
      bf16* out0 = xs + ((row_base + r0) * F + f) * C + hoff + 2 * t;
      bf16* out1 = xs + ((row_base + r1) * F + f) * C + hoff + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        if (r0 < rows)
          *reinterpret_cast<__nv_bfloat162*>(out0 + n * 8) =
              __floats2bfloat162_rn(oacc[n][0] / l0, oacc[n][1] / l0);
        if (r1 < rows)
          *reinterpret_cast<__nv_bfloat162*>(out1 + n * 8) =
              __floats2bfloat162_rn(oacc[n][2] / l1, oacc[n][3] / l1);
      }
      __syncthreads();  // this buffer is refilled by the next step's copy
    }
  }

  // ---- q2 and stage 2 (trajectory_stage2.cuh) ------------------------------
  stage2_q2(smem, xs, wq2, bq2, q2, out, s0, rows, row_base, F, N, C, scale);
  stage2_core(smem, xs, wk2, out, rows, row_base, F, C, heads);
}

template <int KT>
cudaError_t launch_v3(const void* q, const void* kf, const void* vf,
                      const void* wq2, const void* bq2, const void* wk2,
                      void* xs, void* q2, void* out, int B, int S, int F,
                      int N, int C, int heads, float scale, cudaStream_t st) {
  const size_t smem = v3_smem<KT>(F);
  cudaError_t err = cudaFuncSetAttribute(
      traj_v3_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B);
  traj_v3_kernel<KT><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kf),
      static_cast<const bf16*>(vf), static_cast<const bf16*>(wq2),
      static_cast<const bf16*>(bq2), static_cast<const bf16*>(wk2),
      static_cast<bf16*>(xs), static_cast<bf16*>(q2), static_cast<bf16*>(out),
      S, F, N, C, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, S, C]; kf, vf [B, F, N, C]; wq2, wk2 [C, C] ([in, out]); bq2 [C];
// xs [B, S, F, C] and q2 [B, S, C] (written for the backward kernel, as
// version 4 writes them); out [B, S, C]; all bf16 and contiguous, with
// S = F * N, C = heads * 64 (a multiple of 128), F <= 8, N <= 256,
// heads <= 16. One launch on ``stream``, counted in *launched; returns the
// first cudaError_t met.
extern "C" int traj_core_v3_bf16(const void* q, const void* kf,
                                 const void* vf, const void* wq2,
                                 const void* bq2, const void* wk2, void* xs,
                                 void* q2, void* out, int* launched, int B,
                                 int S, int F, int N, int C, int heads,
                                 float scale, void* stream) {
  *launched = 0;
  if (B <= 0 || N <= 0 || N > MAX_NP || F <= 0 || F > MAX_F || S != F * N ||
      heads <= 0 || heads > MAX_HEADS || C != heads * HD || C % GN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kt = (N + 15) / 16;
  cudaError_t err;
  if (kt <= 4)
    err = launch_v3<4>(q, kf, vf, wq2, bq2, wk2, xs, q2, out, B, S, F, N, C,
                       heads, scale, st);
  else if (kt <= 8)
    err = launch_v3<8>(q, kf, vf, wq2, bq2, wk2, xs, q2, out, B, S, F, N, C,
                       heads, scale, st);
  else if (kt <= 13)
    err = launch_v3<13>(q, kf, vf, wq2, bq2, wk2, xs, q2, out, B, S, F, N, C,
                        heads, scale, st);
  else
    err = launch_v3<16>(q, kf, vf, wq2, bq2, wk2, xs, q2, out, B, S, F, N, C,
                        heads, scale, st);
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}
