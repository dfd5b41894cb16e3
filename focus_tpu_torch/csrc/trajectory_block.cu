// Fused trajectory-attention core for Hopper (sm_90a), non-CLS tokens.
//
// Replaces the TPU kernel focus_tpu/ops/pallas/trajectory_block.py
// (_fused_kernel_v4, called through _fused_fwd_pallas_v4 /
// fused_trajectory_core). Same function, three launches:
//
//   stage 1 (one block per batch row, head and 128-query tile): for every
//     frame f, a true max-subtracted softmax of q . k_f^T * scale over that
//     frame's N keys, then P . v_f, written as xs[b, s, f, head] in bf16.
//     Each warp owns 16 query rows and keeps their logits for a whole frame
//     in registers (mma.sync m16n8k16, ldmatrix from the frame's K/V tiles
//     in shared memory); the softmax runs on those registers and the bf16
//     weights feed the PV product directly as A fragments.
//   stage 2a (a tiled GEMM): q2 = x_diag . Wq2 + bq2, where the own-frame
//     row x_diag = xs[b, s, s / N] is gathered as the tiles are copied in.
//   stage 2b (one block per 64 query rows and group of heads): per head
//     g_h = q2_h . Wk2[:, h]^T, logits g_h . xs[f] over all C channels
//     times scale, a softmax over the F frames, and sum_f a2[f] xs[f, h].
//     The k2 bias is constant over frames and drops out of that softmax.
//
// Rounding points follow the plain version at bf16 (ops/attention.py):
// stage-1 weights, xs, q2, g and the stage-2 weights are rounded to bf16;
// every product accumulates in float32 (the matrix products on the tensor
// cores with mma.sync).
//
// Bound on this card: ~92 GFLOP per call at the flagship shape (B = 8,
// S = 1568) against ~60 MB of inputs and outputs, so it is bound by
// operations. The catch for a design is that stage-2 logits for one head
// contract against all C channels of xs, so every head's stage 2 needs every
// head's stage 1. This version keeps xs in a bf16 scratch in device memory
// ([B, S, F, C], ~154 MB at B = 8; q2 adds ~19 MB) between the launches;
// keeping it on chip as the TPU kernel does, with TMA and wgmma, is later
// work.

#include "mma_sm90.cuh"

namespace {

constexpr int HD = 64;           // head dim
constexpr int LDH = HD + 8;      // bf16 stride of 64-wide tiles (144 bytes)
constexpr int S1_ROWS = 128;     // stage-1 query rows per block (8 warps x 16)
constexpr int S1_THREADS = 256;
constexpr int THREADS = 128;     // stage 2b
constexpr int MAX_NP = 256;      // keys per frame after padding to 16
constexpr int MAX_F = 8;         // frames; also the stride of the logits
constexpr int MAX_HEADS = 16;

// ---- stage 1 -------------------------------------------------------------
// Shared memory: two buffers, each a K tile and a V tile [16 KT][LDH] bf16,
// so the next frame's tiles are copied in (cp.async) while this frame's are
// used; the first K tile has at least 128 rows because it first stages the
// Q tile. KT = keys per frame / 16, rounded up to an instantiated size.

template <int KT>
__host__ __device__ constexpr int stage1_krows() {
  return 16 * KT > S1_ROWS ? 16 * KT : S1_ROWS;
}

template <int KT>
constexpr size_t stage1_smem() {
  return (size_t)(stage1_krows<KT>() + 3 * 16 * KT) * LDH * sizeof(bf16);
}

template <int KT>
__global__ void __launch_bounds__(S1_THREADS) traj_stage1_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kf,
    const bf16* __restrict__ vf, bf16* __restrict__ xs, int S, int F, int N,
    int C, float scale) {
  constexpr int NP = 16 * KT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* K0 = reinterpret_cast<bf16*>(smem);
  bf16* V0 = K0 + stage1_krows<KT>() * LDH;
  bf16* K1 = V0 + NP * LDH;
  bf16* V1 = K1 + NP * LDH;

  const int s0 = blockIdx.x * S1_ROWS, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int hoff = head * HD;

  // the Q tile, staged through the first K buffer into A fragments
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
  // padding key rows stay zero in both buffers
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
  for (int f = 0; f < F; ++f) {
    if (f + 1 < F) {
      issue_frame(f + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // frame f's tiles have landed for every thread
    const bf16* Ks = (f & 1) ? K1 : K0;
    const bf16* Vs = (f & 1) ? V1 : V0;

    // logits of this warp's 16 rows against the frame's keys: tile n holds
    // keys 8n + 2t + {0, 1} of rows g (elements 0, 1) and g + 8 (2, 3)
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

    // max-subtracted softmax over the N valid keys (a row's values are
    // spread over the 4 lanes of a quad)
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
    // __expf (ex2.approx) errs by a few ulp, far below the bf16 rounding
    // the weights get next
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

    // P . V: the normalised bf16 weights of key tile j are the A fragment
    float oacc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const uint32_t pa[4] = {
          pack_bf16x2(sacc[2 * j][0] * inv0, sacc[2 * j][1] * inv0),
          pack_bf16x2(sacc[2 * j][2] * inv1, sacc[2 * j][3] * inv1),
          pack_bf16x2(sacc[2 * j + 1][0] * inv0, sacc[2 * j + 1][1] * inv0),
          pack_bf16x2(sacc[2 * j + 1][2] * inv1, sacc[2 * j + 1][3] * inv1)};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + (j * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                       LDH + dp * 16 + 8 * (lane >> 4));
        mma_16816(oacc[2 * dp], pa, vb[0], vb[1]);
        mma_16816(oacc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }

    bf16* out0 = xs + (((size_t)b * S + row0) * F + f) * C + hoff + 2 * t;
    bf16* out1 = xs + (((size_t)b * S + row1) * F + f) * C + hoff + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(out0 + n * 8) =
            __floats2bfloat162_rn(oacc[n][0], oacc[n][1]);
      if (row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(out1 + n * 8) =
            __floats2bfloat162_rn(oacc[n][2], oacc[n][3]);
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copy
  }
}

template <int KT>
cudaError_t launch_stage1(const bf16* q, const bf16* kf, const bf16* vf,
                          bf16* xs, int B, int S, int F, int N, int C,
                          int heads, float scale, cudaStream_t st) {
  constexpr size_t smem = stage1_smem<KT>();
  cudaError_t err = cudaFuncSetAttribute(
      traj_stage1_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + S1_ROWS - 1) / S1_ROWS, heads, B);
  traj_stage1_kernel<KT><<<grid, S1_THREADS, smem, st>>>(q, kf, vf, xs, S, F,
                                                         N, C, scale);
  return cudaGetLastError();
}

// ---- stage 2a: q2 = x_diag . Wq2 + bq2 -----------------------------------
// A tiled GEMM over the flattened rows m = b * S + s (M = B * S): 128 x 128
// output tiles, 8 warps of 64 x 32, k-steps of 32 copied in (cp.async) one
// step ahead of use. Row m of A is xs[m, s / N] (its own-frame aggregate),
// gathered as the tile is copied. The result is rounded to bf16, as the
// plain version rounds q2.

constexpr int GM = 128, GN = 128, GK = 32, G_THREADS = 256;
constexpr int LDA_G = GK + 8;  // bf16 strides keep ldmatrix conflict-free
constexpr int LDB_G = GN + 8;

__global__ void __launch_bounds__(G_THREADS) traj_q2_kernel(
    const bf16* __restrict__ xs, const bf16* __restrict__ wq2,
    const bf16* __restrict__ bq2, bf16* __restrict__ q2, int M, int S, int F,
    int N, int C) {
  __shared__ __align__(128) bf16 As[2][GM * LDA_G];
  __shared__ __align__(128) bf16 Bs[2][GK * LDB_G];
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;  // warp tile rows wm*64, cols wn*32

  // each thread copies two 16-byte pieces of A and of B per k-step
  const bf16* arow[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = m0 + ((tid + j * G_THREADS) >> 2);
    arow[j] = m < M ? xs + ((size_t)m * F + (m % S) / N) * C : nullptr;
  }
  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * G_THREADS;
      bf16* dst = As[stage] + (i >> 2) * LDA_G + (i & 3) * 8;
      if (arow[j]) cp_async16(dst, arow[j] + k0 + (i & 3) * 8);
      else zero16(dst);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * G_THREADS;
      const int r = i >> 4, n = n0 + (i & 15) * 8;
      bf16* dst = Bs[stage] + r * LDB_G + (i & 15) * 8;
      if (n < C) cp_async16(dst, wq2 + (size_t)(k0 + r) * C + n);
      else zero16(dst);
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

  const int KT = C / GK;
  load_tile(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load_tile((kt + 1) & 1, (kt + 1) * GK);
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
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], At + (wm * 64 + i * 16 + (lane & 7) +
                                 8 * ((lane >> 3) & 1)) * LDA_G +
                               kk * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, Bt + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                       LDB_G + wn * 32 + jp * 16 + 8 * (lane >> 4));
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
      if (col >= C) continue;
      const float b0 = __bfloat162float(bq2[col]);
      const float b1 = __bfloat162float(bq2[col + 1]);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = m0 + wm * 64 + i * 16 + g + 8 * hi;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(q2 + (size_t)row * C + col) =
              __floats2bfloat162_rn(acc[i][j][2 * hi] + b0,
                                    acc[i][j][2 * hi + 1] + b1);
      }
    }
  }
}

// ---- stage 2b: stage-2 logits, F-softmax and the weighted sum ------------
// One block per 64 flattened rows (4 warps of 16 rows) and group of up to
// MAX_HPG heads: the output channels of head h need only that head's
// weights, so the heads are split over blocks to give the card enough
// warps. A warp keeps its rows' q2 fragments for the group's heads in
// registers. For each 32-channel chunk of xs, the chunk and the matching
// rows of Wk2 are copied to shared memory; per head, a warp forms its rows'
// g_h chunk = q2_h . Wk2[chunk, h]^T with mma.sync, rounds it to bf16 and
// dots it with the chunk for every frame. Each thread keeps its partial
// logits in registers across chunks; the four lanes sharing a row add
// theirs once at the end. Shared memory: XC [64][F * LDC + 8] bf16 (the
// extra 8 spread a row's reads over the banks) | LG [64][heads per
// group][MAX_F] float | WK [32][heads per group * 64 + 8] bf16.

constexpr int S2_ROWS = 64;
constexpr int S2_CH = 32;          // xs channels per chunk
constexpr int LDC = S2_CH + 8;
constexpr int MAX_HPG = 3;          // heads per block

__host__ __device__ inline int head_groups(int heads) {
  return (heads + MAX_HPG - 1) / MAX_HPG;
}

__host__ __device__ inline int heads_per_group(int heads) {
  return (heads + head_groups(heads) - 1) / head_groups(heads);
}

__host__ __device__ inline size_t stage2_xc_bytes(int F) {
  return round_up((size_t)S2_ROWS * (F * LDC + 8) * sizeof(bf16), 128);
}

__host__ __device__ inline size_t stage2_lg_bytes(int hpg) {
  return round_up((size_t)S2_ROWS * hpg * MAX_F * sizeof(float), 128);
}

__host__ __device__ inline size_t stage2_smem(int F, int hpg) {
  return stage2_xc_bytes(F) + stage2_lg_bytes(hpg) +
         (size_t)S2_CH * (hpg * HD + 8) * sizeof(bf16);
}

__global__ void __launch_bounds__(THREADS) traj_stage2_kernel(
    const bf16* __restrict__ xs, const bf16* __restrict__ q2,
    const bf16* __restrict__ wk2, bf16* __restrict__ out, int M, int F, int C,
    int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hpg = heads_per_group(heads);
  const int h0 = blockIdx.x * hpg, h1 = min(h0 + hpg, heads);
  if (h0 >= h1) return;
  const int XCR = F * LDC + 8, LDW = (h1 - h0) * HD + 8;
  bf16* XC = reinterpret_cast<bf16*>(smem);
  float* LG = reinterpret_cast<float*>(smem + stage2_xc_bytes(F));
  bf16* WK = reinterpret_cast<bf16*>(smem + stage2_xc_bytes(F) +
                                     stage2_lg_bytes(hpg));

  const int m0 = blockIdx.y * S2_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's block rows

  // q2 A fragments of rows r0 / r1 for every head of the group
  uint32_t a[MAX_HPG][HD / 16][4];
  {
    const bool ok0 = m0 + r0 < M, ok1 = m0 + r1 < M;
    const bf16* q2r0 = q2 + (size_t)(m0 + r0) * C + 2 * t;
    const bf16* q2r1 = q2 + (size_t)(m0 + r1) * C + 2 * t;
#pragma unroll
    for (int hi = 0; hi < MAX_HPG; ++hi)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int col = (h0 + hi) * HD + kk * 16;
        const bool live = h0 + hi < h1;
        a[hi][kk][0] = live && ok0 ? ldg32(q2r0 + col) : 0u;
        a[hi][kk][1] = live && ok1 ? ldg32(q2r1 + col) : 0u;
        a[hi][kk][2] = live && ok0 ? ldg32(q2r0 + col + 8) : 0u;
        a[hi][kk][3] = live && ok1 ? ldg32(q2r1 + col + 8) : 0u;
      }
  }

  // partial logits of rows r0 / r1 over this thread's columns
  float part[MAX_HPG][MAX_F][2];
#pragma unroll
  for (int hi = 0; hi < MAX_HPG; ++hi)
#pragma unroll
    for (int f = 0; f < MAX_F; ++f) part[hi][f][0] = part[hi][f][1] = 0.0f;

  for (int cc = 0; cc < C; cc += S2_CH) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < S2_ROWS * F * (S2_CH / 8); i += THREADS) {
      const int r = i / (F * (S2_CH / 8)), rem = i % (F * (S2_CH / 8));
      const int f = rem / (S2_CH / 8), c8 = (rem % (S2_CH / 8)) * 8;
      const int m = m0 + r;
      bf16* dst = XC + r * XCR + f * LDC + c8;
      if (m < M) copy16(dst, xs + ((size_t)m * F + f) * C + cc + c8);
      else zero16(dst);
    }
    const int w8 = (h1 - h0) * HD / 8;
    for (int i = tid; i < S2_CH * w8; i += THREADS) {
      const int r = i / w8, c8 = (i % w8) * 8;
      copy16(WK + r * LDW + c8, wk2 + (size_t)(cc + r) * C + h0 * HD + c8);
    }
    __syncthreads();
#pragma unroll
    for (int hi = 0; hi < MAX_HPG; ++hi) {
      if (h0 + hi >= h1) break;
      // g[r, cc + 8j + 2t + {0, 1}] for rows r0 (elements 0, 1), r1 (2, 3)
      float acc[S2_CH / 8][4];
#pragma unroll
      for (int j = 0; j < S2_CH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
      for (int jp = 0; jp < S2_CH / 16; ++jp)
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t kb[4];
          ldmatrix_x4(kb, WK + (jp * 16 + (lane & 7) + 8 * (lane >> 4)) * LDW +
                              hi * HD + kk * 16 + 8 * ((lane >> 3) & 1));
          mma_16816(acc[2 * jp], a[hi][kk], kb[0], kb[1]);
          mma_16816(acc[2 * jp + 1], a[hi][kk], kb[2], kb[3]);
        }
#pragma unroll
      for (int j = 0; j < S2_CH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = round_bf16(acc[j][e]);
      const bf16* x0 = XC + r0 * XCR + 2 * t;
      const bf16* x1 = XC + r1 * XCR + 2 * t;
#pragma unroll
      for (int f = 0; f < MAX_F; ++f) {
        if (f >= F) break;
#pragma unroll
        for (int j = 0; j < S2_CH / 8; ++j) {
          const float2 xa = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x0 + f * LDC + 8 * j));
          const float2 xb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x1 + f * LDC + 8 * j));
          part[hi][f][0] = fmaf(acc[j][0], xa.x, fmaf(acc[j][1], xa.y, part[hi][f][0]));
          part[hi][f][1] = fmaf(acc[j][2], xb.x, fmaf(acc[j][3], xb.y, part[hi][f][1]));
        }
      }
    }
  }

  // the four lanes of a quad hold one row's columns: add their partials
#pragma unroll
  for (int hi = 0; hi < MAX_HPG; ++hi) {
    if (h0 + hi >= h1) break;
#pragma unroll
    for (int f = 0; f < MAX_F; ++f) {
      if (f >= F) break;
      float p0 = part[hi][f][0], p1 = part[hi][f][1];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        p0 += __shfl_xor_sync(0xffffffffu, p0, o);
        p1 += __shfl_xor_sync(0xffffffffu, p1, o);
      }
      if ((f & 3) == t) {
        LG[(r0 * hpg + hi) * MAX_F + f] = p0;
        LG[(r1 * hpg + hi) * MAX_F + f] = p1;
      }
    }
  }
  __syncthreads();

  // softmax over frames -> bf16-rounded weights, in place
  for (int p = tid; p < S2_ROWS * (h1 - h0); p += THREADS) {
    float* l = LG + ((p / (h1 - h0)) * hpg + p % (h1 - h0)) * MAX_F;
    float mx = -INFINITY;
    for (int f = 0; f < F; ++f) mx = fmaxf(mx, l[f] * scale);
    float sum = 0.0f;
    for (int f = 0; f < F; ++f) sum += expf(l[f] * scale - mx);
    for (int f = 0; f < F; ++f) l[f] = round_bf16(expf(l[f] * scale - mx) / sum);
  }
  __syncthreads();

  // out[m, c] = sum_f a2[m, head(c), f] * xs[m, f, c] for this group's
  // channels, 8 channels a thread
  const int c8n = (h1 - h0) * HD / 8;
  for (int i = tid; i < S2_ROWS * c8n; i += THREADS) {
    const int r = i / c8n, c8 = h0 * HD + (i % c8n) * 8, m = m0 + r;
    if (m >= M) continue;
    const float* a2 = LG + (r * hpg + (c8 / HD - h0)) * MAX_F;
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = 0.0f;
    for (int f = 0; f < F; ++f) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(xs + ((size_t)m * F + f) * C + c8);
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = fmaf(a2[f], __bfloat162float(xv[j]), o[j]);
    }
    uint4 packed;
    bf16* ov = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) ov[j] = __float2bfloat16(o[j]);
    *reinterpret_cast<uint4*>(out + (size_t)m * C + c8) = packed;
  }
}

}  // namespace

// q [B, S, C]; kf, vf [B, F, N, C]; wq2, wk2 [C, C] ([in, out]); bq2 [C];
// scratch xs [B, S, F, C] and q2 [B, S, C]; out [B, S, C]; all bf16 and
// contiguous, with S = F * N, C = heads * 64 (a multiple of 128),
// F <= 8, N <= 256, heads <= 16. Launches the three stages on ``stream``
// and returns the first cudaError_t met.
extern "C" int traj_core_bf16(const void* q, const void* kf, const void* vf,
                              const void* wq2, const void* bq2,
                              const void* wk2, void* xs, void* q2, void* out,
                              int B, int S, int F, int N, int C, int heads,
                              float scale, void* stream) {
  if (B <= 0 || N <= 0 || N > MAX_NP || F <= 0 || F > MAX_F || S != F * N ||
      heads <= 0 || heads > MAX_HEADS || C != heads * HD || C % GN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;

  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* kf_ = static_cast<const bf16*>(kf);
  const bf16* vf_ = static_cast<const bf16*>(vf);
  bf16* xs_ = static_cast<bf16*>(xs);
  const int kt = (N + 15) / 16;
  if (kt <= 4)
    err = launch_stage1<4>(q_, kf_, vf_, xs_, B, S, F, N, C, heads, scale, st);
  else if (kt <= 8)
    err = launch_stage1<8>(q_, kf_, vf_, xs_, B, S, F, N, C, heads, scale, st);
  else if (kt <= 13)
    err = launch_stage1<13>(q_, kf_, vf_, xs_, B, S, F, N, C, heads, scale, st);
  else
    err = launch_stage1<16>(q_, kf_, vf_, xs_, B, S, F, N, C, heads, scale, st);
  if (err != cudaSuccess) return (int)err;

  const int M = B * S;
  const dim3 gq((C + GN - 1) / GN, (M + GM - 1) / GM);
  traj_q2_kernel<<<gq, G_THREADS, 0, st>>>(
      xs_, static_cast<const bf16*>(wq2), static_cast<const bf16*>(bq2),
      static_cast<bf16*>(q2), M, S, F, N, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem2 = stage2_smem(F, heads_per_group(heads));
  err = cudaFuncSetAttribute(traj_stage2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(head_groups(heads), (M + S2_ROWS - 1) / S2_ROWS);
  traj_stage2_kernel<<<g2, THREADS, smem2, st>>>(
      xs_, static_cast<const bf16*>(q2), static_cast<const bf16*>(wk2),
      static_cast<bf16*>(out), M, F, C, heads, scale);
  return (int)cudaGetLastError();
}
