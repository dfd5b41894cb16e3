// Pieces of the trajectory-attention kernels shared by their sources: the
// mma.sync stage-1 kernel, per frame softmax(q . k_f^T * scale) . v_f for
// every query row (or its own frame alone), which the v5 and v6 forwards
// (trajectory_block_v5.cu, trajectory_block_v6.cu) run, and a tiled bf16
// GEMM with an optional row gather, bias and scaled second output, which
// they and the forward versions 4, 3 and 7 (trajectory_block.cu, for q2)
// run. Versions 4, 3 and 7 and the space stage run stage 1 on wgmma and
// TMA (space_stage_core.cuh). ops/_build.py hashes this header with every
// source.

#pragma once

#include "mma_sm90.cuh"

namespace {

constexpr int HD = 64;           // head dim
constexpr int LDH = HD + 8;      // bf16 stride of 64-wide tiles (144 bytes)
constexpr int S1_ROWS = 128;     // stage-1 query rows per block (8 warps x 16)
constexpr int S1_THREADS = 256;
constexpr int MAX_NP = 256;      // keys per frame after padding to 16
constexpr int MAX_F = 8;         // frames; also the stride of the logits
constexpr int MAX_HEADS = 16;

// ---- stage 1 -------------------------------------------------------------
// One block per batch row (or batch x head row), head and 128-query tile:
// for every frame f, a true max-subtracted softmax of q . k_f^T * scale over
// that frame's N keys, then P . v_f, written as out[b, s, f, head] in bf16.
// Each warp owns 16 query rows and keeps their logits for a whole frame in
// registers (mma.sync m16n8k16, ldmatrix from the frame's K/V tiles in
// shared memory); the softmax runs on those registers and the normalised
// bf16 weights feed the PV product directly as A fragments. With DIAG the
// block visits only the frames its rows belong to and writes each row's own
// frame alone, as out[b, s, head] (the own-frame aggregate x_diag).
//
// Shared memory: two buffers, each a K tile and a V tile [16 KT][LDH] bf16,
// so the next frame's tiles are copied in (cp.async) while this frame's are
// used; the first K tile has at least 128 rows because it first stages the
// Q tile. KT = keys per frame / 16, rounded up to an instantiated size.

template <int KT>
__host__ __device__ constexpr int stage1_krows() {
  return 16 * KT > S1_ROWS ? 16 * KT : S1_ROWS;
}

template <int KT>
__host__ __device__ constexpr size_t stage1_smem() {
  return (size_t)(stage1_krows<KT>() + 3 * 16 * KT) * LDH * sizeof(bf16);
}

template <int KT, bool DIAG>
__global__ void __launch_bounds__(S1_THREADS) traj_stage1_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kf,
    const bf16* __restrict__ vf, bf16* __restrict__ out, int S, int F, int N,
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
  // frames visited: all of them, or (DIAG) those of this block's rows
  const int f0 = DIAG ? s0 / N : 0;
  const int nf = DIAG ? min(s0 + S1_ROWS - 1, S - 1) / N - f0 + 1 : F;
  auto issue_frame = [&](int fi) {  // fi-th visited frame, buffer fi % 2
    const size_t kv0 = ((size_t)b * F + f0 + fi) * N * C + hoff;
    bf16* Kd = (fi & 1) ? K1 : K0;
    bf16* Vd = (fi & 1) ? V1 : V0;
    for (int i = tid; i < N * 8; i += S1_THREADS) {
      const int r = i >> 3, c8 = (i & 7) * 8;
      cp_async16(Kd + r * LDH + c8, kf + kv0 + (size_t)r * C + c8);
      cp_async16(Vd + r * LDH + c8, vf + kv0 + (size_t)r * C + c8);
    }
    cp_async_commit();
  };
  issue_frame(0);

  const int row0 = s0 + warp * 16 + g, row1 = row0 + 8;
  for (int i = 0; i < nf; ++i) {
    const int f = f0 + i;
    if (i + 1 < nf) {
      issue_frame(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // frame f's tiles have landed for every thread
    const bf16* Ks = (i & 1) ? K1 : K0;
    const bf16* Vs = (i & 1) ? V1 : V0;

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

    const int fo = DIAG ? 1 : F;  // frames per output row
    bf16* out0 = out + (((size_t)b * S + row0) * fo + (DIAG ? 0 : f)) * C +
                 hoff + 2 * t;
    bf16* out1 = out + (((size_t)b * S + row1) * fo + (DIAG ? 0 : f)) * C +
                 hoff + 2 * t;
    const bool w0 = row0 < S && (!DIAG || row0 / N == f);
    const bool w1 = row1 < S && (!DIAG || row1 / N == f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (w0)
        *reinterpret_cast<__nv_bfloat162*>(out0 + n * 8) =
            __floats2bfloat162_rn(oacc[n][0], oacc[n][1]);
      if (w1)
        *reinterpret_cast<__nv_bfloat162*>(out1 + n * 8) =
            __floats2bfloat162_rn(oacc[n][2], oacc[n][3]);
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copy
  }
}

template <int KT, bool DIAG>
cudaError_t launch_stage1_kt(const bf16* q, const bf16* kf, const bf16* vf,
                             bf16* out, int B, int S, int F, int N, int C,
                             int heads, float scale, cudaStream_t st) {
  constexpr size_t smem = stage1_smem<KT>();
  cudaError_t err = cudaFuncSetAttribute(
      traj_stage1_kernel<KT, DIAG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + S1_ROWS - 1) / S1_ROWS, heads, B);
  traj_stage1_kernel<KT, DIAG><<<grid, S1_THREADS, smem, st>>>(
      q, kf, vf, out, S, F, N, C, scale);
  return cudaGetLastError();
}

// q [B, S, C], kf / vf [B, F, N, C] (head h in channels 64h..64h+63) ->
// out [B, S, F, C], or [B, S, C] with DIAG; N <= MAX_NP, C = heads * 64
template <bool DIAG>
cudaError_t launch_stage1(const bf16* q, const bf16* kf, const bf16* vf,
                          bf16* out, int B, int S, int F, int N, int C,
                          int heads, float scale, cudaStream_t st) {
  const int kt = (N + 15) / 16;
  if (kt <= 4)
    return launch_stage1_kt<4, DIAG>(q, kf, vf, out, B, S, F, N, C, heads,
                                     scale, st);
  if (kt <= 8)
    return launch_stage1_kt<8, DIAG>(q, kf, vf, out, B, S, F, N, C, heads,
                                     scale, st);
  if (kt <= 13)
    return launch_stage1_kt<13, DIAG>(q, kf, vf, out, B, S, F, N, C, heads,
                                      scale, st);
  return launch_stage1_kt<16, DIAG>(q, kf, vf, out, B, S, F, N, C, heads,
                                    scale, st);
}

// ---- a tiled GEMM: out = A . W (+ bias), [M, C] x [C, C] ------------------
// 128 x 128 output tiles, 8 warps of 64 x 32, k-steps of 32 copied in
// (cp.async) one step ahead of use, float32 sums rounded once to bf16. Row m
// of A is A[m * F + (m % S) / N]: with F > 1 the own-frame aggregate
// xs[b, s, s / N] of the flattened row m = b * S + s, gathered as the tile
// is copied (q2 = x_diag . Wq2 + bq2); with F = 1 and S = N, row m itself
// (k2v = V . Wk2; q2 from x_diag). A null bias adds nothing. A non-null
// ``scaled`` also receives round((acc + bias) * scale) (the stage-2 query of
// the forward versions 3 and 7, rounded from float32, not from the rounded
// out: round(round(x) * scale) is round(x * scale) only where scale is a
// power of two).

constexpr int GM = 128, GN = 128, GK = 32, G_THREADS = 256;
constexpr int LDA_G = GK + 8;  // bf16 strides keep ldmatrix conflict-free
constexpr int LDB_G = GN + 8;

__global__ void __launch_bounds__(G_THREADS) traj_gemm_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, bf16* __restrict__ out,
    bf16* __restrict__ scaled, int M, int S, int F, int N, int C,
    float scale) {
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
    arow[j] = m < M ? a + ((size_t)m * F + (m % S) / N) * C : nullptr;
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
      if (n < C) cp_async16(dst, w + (size_t)(k0 + r) * C + n);
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
      const float b0 = bias ? __bfloat162float(bias[col]) : 0.0f;
      const float b1 = bias ? __bfloat162float(bias[col + 1]) : 0.0f;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = m0 + wm * 64 + i * 16 + g + 8 * hi;
        if (row >= M) continue;
        const float v0 = acc[i][j][2 * hi] + b0;
        const float v1 = acc[i][j][2 * hi + 1] + b1;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * C + col) =
            __floats2bfloat162_rn(v0, v1);
        if (scaled)
          *reinterpret_cast<__nv_bfloat162*>(scaled + (size_t)row * C + col) =
              __floats2bfloat162_rn(v0 * scale, v1 * scale);
      }
    }
  }
}


cudaError_t launch_gemm(const bf16* a, const bf16* w, const bf16* bias,
                        bf16* out, int M, int S, int F, int N, int C,
                        cudaStream_t st, bf16* scaled = nullptr,
                        float scale = 1.0f) {
  const dim3 grid((C + GN - 1) / GN, (M + GM - 1) / GM);
  traj_gemm_kernel<<<grid, G_THREADS, 0, st>>>(a, w, bias, out, scaled, M, S,
                                               F, N, C, scale);
  return cudaGetLastError();
}

}  // namespace
