// Trajectory core, forward version 7, for Hopper (sm_90a), non-CLS tokens.
//
// Replaces the TPU kernel focus_tpu/ops/pallas/trajectory_block.py
// (_fused_kernel_v7, called through _fused_fwd_pallas_v7 under
// FWD_VERSION = 7): the function of version 4 (trajectory_block.cu) rounded
// as version 3 rounds it (the weights rounded before they are normalised,
// xs = round(o / s), the fouter stage 2), in one launch per call. One block
// per batch row and query block of BQ = 128 rows, as the TPU kernel's grid
// (b, query block) has no frame axis: the block runs stage 1 for every head
// and frame, then q2 and stage 2 for its own rows (trajectory_stage2.cuh,
// shared with version 3).
//
// Stage 1 is v7's transposed form, redone for this card:
//   head outer, all frames inside: for each head the block's Q head tile is
//     copied in once (cp.async, into one of two buffers by head parity) and
//     each warp keeps its 16 query columns of it as mma B fragments in
//     registers, while all F frames' K / V head tiles stream past it,
//     double-buffered (cp.async, one step ahead). The TPU kernel loops over
//     the heads around its whole [F * np8, BQ] logit matrix; version 3 is
//     frame outer and copies a Q head tile in at every step.
//   logits transposed: S^T = K_f . Q_h^T by mma.sync m16n8k16, keys on the
//     mma's M dimension and queries on N. Each warp owns 16 query columns
//     and all keys of the frame, so a column's max is the warp's own: in
//     thread over the key tiles, then across lanes with xor 4, 8 and 16.
//     Keys are packed to this card's granularity, 16 rows a frame (196 and
//     200 -> 208), as trajectory_core.cuh pads them: the counterpart of
//     v7's 8-row sublane packing. p = exp(logit * scale - max) with a true
//     per-(query, frame) max (the TPU kernel clamps exp2 with no max,
//     ROADMAP defect 2) and 0 at padding keys.
//   normaliser sums on the tensor cores (v7's masked sum_mask product): the
//     PV product is formed transposed, O^T = V_f^T . P^T, with P^T as the B
//     operand (k = keys, n = queries) and V_f^T as A (ldmatrix.trans of the
//     [key][channel] tile). The frame's valid-key mask is one more A row (a
//     fifth m-tile whose row 0 is 1 at keys < N and 0 elsewhere), so the
//     product that forms P . V also gives s_f in that tile's accumulator
//     row. v7 sums at HIGHEST precision, and the plain version sums the
//     unrounded float32 p, so the mask row meets p twice, as a hi + lo bf16
//     pair: round(p) and round(p - round(p)) (|error| < 2^-16 p); the V rows
//     meet the hi half alone, exactly v7's p.astype(v.dtype).
//   P^T through shared memory: the S^T accumulator gives a thread keys g,
//     g + 8 of queries 2t, 2t + 1, where a B fragment wants keys 2t, 2t + 1
//     (+ 8) of query g. So each warp stores its bf16 hi and lo weights of
//     one 16-key tile, [key][query], to its own staging tile and reads them
//     back with ldmatrix.trans (warp-local, __syncwarp only), one key tile
//     at a time, straight into that tile's PV and mask products.
//   xs_f = round(o / s): O^T lands channel-major (a thread holds channels
//     g, g + 8 of queries 2t, 2t + 1); s reaches the quad from lane t of the
//     mask tile by a shuffle. The warp stages its [16 queries][64 channels]
//     bf16 tile in shared memory, so that each query row of xs [B, S, F, C]
//     is stored as 16-byte pieces of 128 contiguous bytes.
//
// BQ = 128 and 8 warps: the shared stage 2 is written for 8 warps of 16
// rows and takes 201 KB at F = 8, one block per SM whatever BQ is (v7 takes
// 256 rows on the TPU); at B = 8, S = 1568 that is 104 blocks in one wave.
// A query block crosses frame boundaries (S = 1568 is not a multiple of
// 128): stage2_q2 gathers each row's own frame, and no write lands past S.
//
// Shared memory, one buffer reused (KT = keys per frame / 16 rounded up to
// an instantiated size, NP = 16 KT; 208 at N = 196, 200):
//   stage 1: two Q tiles [128][72], two K and two V tiles [NP][72], and per
//            warp a P staging pair [2][16][24] and an xs staging tile
//            [16][72], bf16: 183 KB at NP = 208 (210 KB at NP = 256);
//   q2 and stage 2: stage2_smem(F), 201 KB at F = 8.
// The block takes the largest, 201 KB at NP = 208 and F = 8.
//
// Bound on this card: version 4's function, 0.0930 ms at B = 8, S = 1568
// (operations, ~92 GFLOP against ~60 MB of inputs and outputs). This
// version, like versions 3 and 4, moves xs [B, S, F, C] (~154 MB at B = 8)
// through device memory (the backward reads it), runs the mask products
// (4 mma a key tile beside PV's 8) on top, and re-reads its batch row's K
// and V in every block (from L2 where its neighbours share them); TMA, wgmma
// and on-chip xs are later work.

#include "trajectory_stage2.cuh"

namespace {

constexpr int BQ = S2_ROWS;       // query rows per block (8 warps x 16)
constexpr int THREADS = S2_THREADS;
constexpr int LDP = 16 + 8;       // bf16 stride of a warp's [16][16] P tile

template <int KT>
__host__ __device__ constexpr size_t v7_kv_elems() {  // one K + V buffer
  return (size_t)2 * 16 * KT * LDH;
}

template <int KT>
__host__ __device__ constexpr size_t v7_stage1_elems() {
  return (size_t)2 * BQ * LDH + 2 * v7_kv_elems<KT>() +
         (size_t)(THREADS / 32) * (2 * 16 * LDP + 16 * LDH);
}

template <int KT>
__host__ __device__ inline size_t v7_smem(int F) {
  const size_t s1 = v7_stage1_elems<KT>() * sizeof(bf16);
  const size_t s2 = stage2_smem(F);
  return s1 > s2 ? s1 : s2;
}

template <int KT>
__global__ void __launch_bounds__(THREADS, 1) traj_v7_kernel(
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
    bf16* base = reinterpret_cast<bf16*>(smem);
    auto qbuf = [&](int j) { return base + j * BQ * LDH; };  // by head parity
    auto kbuf = [&](int j) {  // by step parity: K [NP][LDH], then V
      return base + 2 * BQ * LDH + j * v7_kv_elems<KT>();
    };
    bf16* stage = base + 2 * BQ * LDH + 2 * v7_kv_elems<KT>() +
                  warp * (2 * 16 * LDP + 16 * LDH);
    bf16* Ph = stage;             // this warp's [16 keys][LDP] hi weights
    bf16* Pl = Ph + 16 * LDP;     // ... and lo weights
    bf16* Ow = Pl + 16 * LDP;     // this warp's [16 queries][LDH] xs tile

    // query rows past S and key rows past N stay zero in both buffers
    for (int i = tid; i < (BQ - rows) * 8; i += THREADS) {
      const int r = rows + (i >> 3), c8 = (i & 7) * 8;
      zero16(qbuf(0) + r * LDH + c8);
      zero16(qbuf(1) + r * LDH + c8);
    }
    for (int i = tid; i < (NP - N) * 8; i += THREADS) {
      const int r = N + (i >> 3), c8 = (i & 7) * 8;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        zero16(kbuf(j) + r * LDH + c8);
        zero16(kbuf(j) + (NP + r) * LDH + c8);
      }
    }
    // step i: head i / F, frame i % F; K / V into buffer i % 2, and at a
    // head's first frame its Q tile into Q buffer head % 2
    auto copy_step = [&](int i) {
      const int h = i / F, f = i % F, hoff = h * HD;
      if (f == 0) {
        bf16* Qd = qbuf(h & 1);
        for (int j = tid; j < rows * 8; j += THREADS) {
          const int r = j >> 3, c8 = (j & 7) * 8;
          cp_async16(Qd + r * LDH + c8, q + (row_base + r) * C + hoff + c8);
        }
      }
      bf16* Kd = kbuf(i & 1);
      bf16* Vd = Kd + NP * LDH;
      const size_t kv0 = ((size_t)b * F + f) * N * C + hoff;
      for (int j = tid; j < N * 8; j += THREADS) {
        const int r = j >> 3, c8 = (j & 7) * 8;
        cp_async16(Kd + r * LDH + c8, kf + kv0 + (size_t)r * C + c8);
        cp_async16(Vd + r * LDH + c8, vf + kv0 + (size_t)r * C + c8);
      }
      cp_async_commit();
    };
    copy_step(0);

    // the valid-key selector's A fragment of key tile j: row 0 (lanes 0-3)
    // is 1 at keys < N, every other row 0
    auto mask_frag = [&](int j, uint32_t (&ma)[4]) {
      const int k0 = j * 16 + 2 * t;
      ma[0] = g == 0 ? pack_bf16x2(k0 < N ? 1.0f : 0.0f,
                                   k0 + 1 < N ? 1.0f : 0.0f) : 0u;
      ma[2] = g == 0 ? pack_bf16x2(k0 + 8 < N ? 1.0f : 0.0f,
                                   k0 + 9 < N ? 1.0f : 0.0f) : 0u;
      ma[1] = ma[3] = 0u;
    };

    uint32_t qb[HD / 16][4];  // this warp's Q columns as B fragments
    const int steps = heads * F;
    for (int i = 0; i < steps; ++i) {
      if (i + 1 < steps) {
        copy_step(i + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // step i's tiles have landed for every thread
      const int h = i / F, f = i % F, hoff = h * HD;
      const bf16* Ks = kbuf(i & 1);
      const bf16* Vs = Ks + NP * LDH;
      if (f == 0) {
        const bf16* Qs = qbuf(h & 1);
        // B[k = channel][n = query]: n-tile 0 in registers 0, 1, 1 in 2, 3
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks)
          ldmatrix_x4(qb[ks], Qs + (warp * 16 + (lane & 7) + 8 * (lane >> 4)) *
                                       LDH + ks * 16 + 8 * ((lane >> 3) & 1));
      }

      // S^T: tile [j][n] holds keys 16j + g (elements 0, 1) and 16j + g + 8
      // (2, 3) of this warp's queries 8n + 2t + {0, 1}
      float sacc[KT][2][4];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[j][n][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          uint32_t ka[4];
          ldmatrix_x4(ka, Ks + (j * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                   LDH + ks * 16 + 8 * (lane >> 4));
          mma_16816(sacc[j][0], ka, qb[ks][0], qb[ks][1]);
          mma_16816(sacc[j][1], ka, qb[ks][2], qb[ks][3]);
        }
      }

      // the column max over the N valid keys: in thread, then over the
      // eight lanes (xor 4, 8, 16) that share this thread's columns
      float m[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) m[n][0] = m[n][1] = -INFINITY;
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j * 16 + g + 8 * (e >> 1);
            const float v = key < N ? sacc[j][n][e] * scale : -INFINITY;
            sacc[j][n][e] = v;
            m[n][e & 1] = fmaxf(m[n][e & 1], v);
          }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            m[n][c] = fmaxf(m[n][c], __shfl_xor_sync(0xffffffffu, m[n][c], o));
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j * 16 + g + 8 * (e >> 1);
            sacc[j][n][e] =
                key < N ? __expf(sacc[j][n][e] - m[n][e & 1]) : 0.0f;
          }

      // O^T = V^T . round(P)^T (channel tiles 0-3) and the sums
      // s = mask . (hi + lo)^T (tile 4, row 0), one key tile at a time
      float oacc[HD / 16][2][4], sacc_s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc_s[n][e] = 0.0f;
#pragma unroll
        for (int c = 0; c < HD / 16; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) oacc[c][n][e] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const float p0 = sacc[j][n][2 * hi], p1 = sacc[j][n][2 * hi + 1];
            const uint32_t ph = pack_bf16x2(p0, p1);
            const float2 r = unpack_bf16x2(ph);
            const int at = (g + 8 * hi) * LDP + n * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(Ph + at) = ph;
            *reinterpret_cast<uint32_t*>(Pl + at) =
                pack_bf16x2(p0 - r.x, p1 - r.y);
          }
        __syncwarp();
        uint32_t pb[4], pl[4], ma[4];
        ldmatrix_x4_trans(pb, Ph + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDP +
                                  8 * (lane >> 4));
        ldmatrix_x4_trans(pl, Pl + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDP +
                                  8 * (lane >> 4));
#pragma unroll
        for (int c = 0; c < HD / 16; ++c) {
          uint32_t va[4];
          ldmatrix_x4_trans(va, Vs + (j * 16 + (lane & 7) + 8 * (lane >> 4)) *
                                         LDH + c * 16 + 8 * ((lane >> 3) & 1));
          mma_16816(oacc[c][0], va, pb[0], pb[1]);
          mma_16816(oacc[c][1], va, pb[2], pb[3]);
        }
        mask_frag(j, ma);
        mma_16816(sacc_s[0], ma, pb[0], pb[1]);
        mma_16816(sacc_s[0], ma, pl[0], pl[1]);
        mma_16816(sacc_s[1], ma, pb[2], pb[3]);
        mma_16816(sacc_s[1], ma, pl[2], pl[3]);
        __syncwarp();  // the staging pair is rewritten by the next key tile
      }

      // xs_f = round(o / s): s of queries 8n + 2t + {0, 1} is in lane t
      float s[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          s[n][c] = __shfl_sync(0xffffffffu, sacc_s[n][c], t);
#pragma unroll
      for (int c = 0; c < HD / 16; ++c)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Ow[(n * 8 + 2 * t + (e & 1)) * LDH + c * 16 + g + 8 * (e >> 1)] =
                __float2bfloat16(oacc[c][n][e] / s[n][e & 1]);
      __syncwarp();
      for (int k = lane; k < 16 * 8; k += 32) {
        const int r = k >> 3, c8 = (k & 7) * 8, row = warp * 16 + r;
        if (row < rows)
          copy16(xs + ((row_base + row) * F + f) * C + hoff + c8,
                 Ow + r * LDH + c8);
      }
      __syncthreads();  // these K / V buffers are refilled by the next copy
    }
  }

  // ---- q2 and stage 2 (trajectory_stage2.cuh) ------------------------------
  stage2_q2(smem, xs, wq2, bq2, q2, out, s0, rows, row_base, F, N, C, scale);
  stage2_core(smem, xs, wk2, out, rows, row_base, F, C, heads);
}

template <int KT>
cudaError_t launch_v7(const void* q, const void* kf, const void* vf,
                      const void* wq2, const void* bq2, const void* wk2,
                      void* xs, void* q2, void* out, int B, int S, int F,
                      int N, int C, int heads, float scale, cudaStream_t st) {
  const size_t smem = v7_smem<KT>(F);
  cudaError_t err = cudaFuncSetAttribute(
      traj_v7_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B);
  traj_v7_kernel<KT><<<grid, THREADS, smem, st>>>(
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
extern "C" int traj_core_v7_bf16(const void* q, const void* kf,
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
    err = launch_v7<4>(q, kf, vf, wq2, bq2, wk2, xs, q2, out, B, S, F, N, C,
                       heads, scale, st);
  else if (kt <= 8)
    err = launch_v7<8>(q, kf, vf, wq2, bq2, wk2, xs, q2, out, B, S, F, N, C,
                       heads, scale, st);
  else if (kt <= 13)
    err = launch_v7<13>(q, kf, vf, wq2, bq2, wk2, xs, q2, out, B, S, F, N, C,
                        heads, scale, st);
  else
    err = launch_v7<16>(q, kf, vf, wq2, bq2, wk2, xs, q2, out, B, S, F, N, C,
                        heads, scale, st);
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}
