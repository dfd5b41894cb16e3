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
//   q2: after the last frame and a __syncthreads() (the block's own writes
//     to xs are then visible to all its threads), x_diag = xs[b, s, s / N]
//     is gathered as 128 x 32 tiles are copied in and multiplied with Wq2
//     streamed in k-steps of 32, one 128-column tile at a time. q2 = acc +
//     bq2 goes to q2 [B, S, C] in bf16 unscaled, as the backward kernel
//     reads it, and round((acc + bq2) * scale), the TPU kernel's stage-2
//     query, to the block's own rows of out, which is free until stage 2
//     writes each head's channels there last.
//   stage 2, over groups of up to HPG = 3 heads (the warp's query fragments
//     for a group are read back from out into registers): for each
//     32-channel chunk of xs (all F frames) and the matching rows of Wk2
//     (cp.async, double-buffered), per head the chunk of g_h = q2_h . Wk2_h^T
//     by mma.sync, kept in float32 (the fouter form does not round it), is
//     dotted with the chunk for every frame into the row's logits. Then
//     a2 = softmax over frames in float32, and out = round(sum_f a2_f xs_f)
//     for the group's channels. bk2 is constant over frames and drops out.
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
//   q2:      two A tiles [128][40] and two Wq2 tiles [32][136] bf16, 37 KB;
//   stage 2: two buffers of xs [128][F * 40 + 8] + Wk2 [32][200] bf16, and
//            the logits [128][3][8] float, 201 KB at F = 8.
// The block takes the largest, 201 KB of the 227 KB a block may have.
//
// Bound on this card: version 4's function, 0.0930 ms at B = 8, S = 1568
// (operations, ~92 GFLOP against ~60 MB of inputs and outputs). This
// version, like version 4, moves xs [B, S, F, C] (~154 MB at B = 8) through
// device memory (the backward reads it), and every block re-reads its batch
// row's K and V (from L2 where its neighbours share them); keeping xs on
// chip with TMA, wgmma and clusters is later work.

#include "trajectory_core.cuh"

namespace {

constexpr int BQ = 128;           // query rows per block (8 warps x 16)
constexpr int THREADS = 256;
constexpr int S2_CH = 32;         // stage-2 xs channels per chunk
constexpr int LDC = S2_CH + 8;
constexpr int HPG = 3;            // stage-2 heads per group
constexpr int LDW = HPG * HD + 8;

template <int KT>
__host__ __device__ constexpr size_t v3_stage1_elems() {  // one buffer
  return (size_t)(BQ + 2 * 16 * KT) * LDH;
}

__host__ __device__ inline size_t v3_xc_elems(int F) {  // one buffer
  return (size_t)BQ * (F * LDC + 8);
}

template <int KT>
__host__ __device__ inline size_t v3_smem(int F) {
  const size_t s1 = 2 * v3_stage1_elems<KT>() * sizeof(bf16);
  const size_t gemm = (size_t)(2 * GM * LDA_G + 2 * GK * LDB_G) * sizeof(bf16);
  const size_t s2 = 2 * (v3_xc_elems(F) + (size_t)S2_CH * LDW) * sizeof(bf16) +
                    (size_t)BQ * HPG * MAX_F * sizeof(float);
  return s1 > gemm ? (s1 > s2 ? s1 : s2) : (gemm > s2 ? gemm : s2);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

  // ---- q2 = x_diag . Wq2 + bq2 ---------------------------------------------
  {
    bf16* As = reinterpret_cast<bf16*>(smem);  // [2][GM * LDA_G]
    bf16* Bs = As + 2 * GM * LDA_G;            // [2][GK * LDB_G]
    const int wm = warp / 4, wn = warp % 4;    // warp tile rows wm*64, cols wn*32
    // each thread copies two 16-byte pieces of A and of B per k-step; A row
    // r is the own-frame aggregate of query row s0 + r
    const bf16* arow[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = (tid + j * THREADS) >> 2, s = s0 + r;
      arow[j] = r < rows ? xs + ((row_base + r) * F + s / N) * C : nullptr;
    }
    for (int n0 = 0; n0 < C; n0 += GN) {
      auto load_tile = [&](int stage, int k0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = tid + j * THREADS;
          bf16* dst = As + stage * GM * LDA_G + (i >> 2) * LDA_G + (i & 3) * 8;
          if (arow[j]) cp_async16(dst, arow[j] + k0 + (i & 3) * 8);
          else zero16(dst);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = tid + j * THREADS;
          const int r = i >> 4, c = (i & 15) * 8;
          cp_async16(Bs + stage * GK * LDB_G + r * LDB_G + c,
                     wq2 + (size_t)(k0 + r) * C + n0 + c);
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

      const int nk = C / GK;
      load_tile(0, 0);
      for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) {
          load_tile((kt + 1) & 1, (kt + 1) * GK);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* At = As + (kt & 1) * GM * LDA_G;
        const bf16* Bt = Bs + (kt & 1) * GK * LDB_G;
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
            ldmatrix_x4_trans(r4, Bt + (kk * 16 + (lane & 7) +
                                        8 * ((lane >> 3) & 1)) * LDB_G +
                                      wn * 32 + jp * 16 + 8 * (lane >> 4));
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
        __syncthreads();  // this stage is refilled by the next k-step's copy
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + wn * 32 + j * 8 + 2 * t;
          const float b0 = __bfloat162float(bq2[col]);
          const float b1 = __bfloat162float(bq2[col + 1]);
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int r = wm * 64 + i * 16 + g + 8 * hi;
            if (r >= rows) continue;
            const float v0 = acc[i][j][2 * hi] + b0;
            const float v1 = acc[i][j][2 * hi + 1] + b1;
            const size_t at = (row_base + r) * C + col;
            *reinterpret_cast<__nv_bfloat162*>(q2 + at) =
                __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(out + at) =
                __floats2bfloat162_rn(v0 * scale, v1 * scale);
          }
        }
      }
    }
    __syncthreads();  // the scaled q2 in out is visible to every thread
  }

  // ---- stage 2 -------------------------------------------------------------
  {
    const int XCR = F * LDC + 8;  // the extra 8 spread a row's reads over banks
    // buffer j: xs chunk [BQ][XCR], then Wk2 chunk [S2_CH][LDW]; then LG
    const size_t s2buf = v3_xc_elems(F) + (size_t)S2_CH * LDW;
    auto xcb = [&](int j) { return reinterpret_cast<bf16*>(smem) + j * s2buf; };
    auto wkb = [&](int j) { return xcb(j) + v3_xc_elems(F); };
    float* LG = reinterpret_cast<float*>(xcb(2));
    const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's block rows
    const bool ok0 = r0 < rows, ok1 = r1 < rows;
    const bf16* qs0 = out + (row_base + r0) * C + 2 * t;
    const bf16* qs1 = out + (row_base + r1) * C + 2 * t;
    const int nchunks = C / S2_CH;

    for (int h0 = 0; h0 < heads; h0 += HPG) {
      const int nh = min(HPG, heads - h0);
      // the scaled q2 A fragments of rows r0 / r1 for the group's heads
      uint32_t a[HPG][HD / 16][4];
#pragma unroll
      for (int hi = 0; hi < HPG; ++hi)
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int col = (h0 + hi) * HD + kk * 16;
          const bool live = hi < nh;
          a[hi][kk][0] = live && ok0 ? ld32(qs0 + col) : 0u;
          a[hi][kk][1] = live && ok1 ? ld32(qs1 + col) : 0u;
          a[hi][kk][2] = live && ok0 ? ld32(qs0 + col + 8) : 0u;
          a[hi][kk][3] = live && ok1 ? ld32(qs1 + col + 8) : 0u;
        }
      // partial logits of rows r0 / r1 over this thread's columns
      float part[HPG][MAX_F][2];
#pragma unroll
      for (int hi = 0; hi < HPG; ++hi)
#pragma unroll
        for (int f = 0; f < MAX_F; ++f) part[hi][f][0] = part[hi][f][1] = 0.0f;

      auto copy_chunk = [&](int ci) {  // into buffer ci % 2
        const int cc = ci * S2_CH;
        bf16* xd = xcb(ci & 1);
        bf16* wd = wkb(ci & 1);
        for (int i = tid; i < BQ * F * (S2_CH / 8); i += THREADS) {
          const int r = i / (F * (S2_CH / 8)), rem = i % (F * (S2_CH / 8));
          const int f = rem / (S2_CH / 8), c8 = (rem % (S2_CH / 8)) * 8;
          bf16* dst = xd + r * XCR + f * LDC + c8;
          if (r < rows) cp_async16(dst, xs + ((row_base + r) * F + f) * C + cc + c8);
          else zero16(dst);
        }
        const int w8 = nh * HD / 8;
        for (int i = tid; i < S2_CH * w8; i += THREADS) {
          const int r = i / w8, c8 = (i % w8) * 8;
          cp_async16(wd + r * LDW + c8, wk2 + (size_t)(cc + r) * C + h0 * HD + c8);
        }
        cp_async_commit();
      };
      copy_chunk(0);
      for (int ci = 0; ci < nchunks; ++ci) {
        if (ci + 1 < nchunks) {
          copy_chunk(ci + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* xc = xcb(ci & 1);
        const bf16* wk = wkb(ci & 1);
#pragma unroll
        for (int hi = 0; hi < HPG; ++hi) {
          if (hi >= nh) break;
          // g[r, cc + 8j + 2t + {0, 1}] for rows r0 (elements 0, 1) and r1
          // (2, 3), float32
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
              ldmatrix_x4(kb, wk + (jp * 16 + (lane & 7) + 8 * (lane >> 4)) * LDW +
                                  hi * HD + kk * 16 + 8 * ((lane >> 3) & 1));
              mma_16816(acc[2 * jp], a[hi][kk], kb[0], kb[1]);
              mma_16816(acc[2 * jp + 1], a[hi][kk], kb[2], kb[3]);
            }
          const bf16* x0 = xc + r0 * XCR + 2 * t;
          const bf16* x1 = xc + r1 * XCR + 2 * t;
#pragma unroll
          for (int f = 0; f < MAX_F; ++f) {
            if (f >= F) break;
#pragma unroll
            for (int j = 0; j < S2_CH / 8; ++j) {
              const float2 xa = unpack_bf16x2(ld32(x0 + f * LDC + 8 * j));
              const float2 xb = unpack_bf16x2(ld32(x1 + f * LDC + 8 * j));
              part[hi][f][0] = fmaf(acc[j][0], xa.x, fmaf(acc[j][1], xa.y, part[hi][f][0]));
              part[hi][f][1] = fmaf(acc[j][2], xb.x, fmaf(acc[j][3], xb.y, part[hi][f][1]));
            }
          }
        }
        __syncthreads();  // this buffer is refilled by the next chunk's copy
      }

      // the four lanes of a quad hold one row's columns: add their partials
#pragma unroll
      for (int hi = 0; hi < HPG; ++hi) {
        if (hi >= nh) break;
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
            LG[(r0 * HPG + hi) * MAX_F + f] = p0;
            LG[(r1 * HPG + hi) * MAX_F + f] = p1;
          }
        }
      }
      __syncthreads();

      // a2 = softmax over frames (the scale is in q2), float32, in place
      for (int p = tid; p < BQ * nh; p += THREADS) {
        float* l = LG + ((p / nh) * HPG + p % nh) * MAX_F;
        float mx = -INFINITY;
        for (int f = 0; f < F; ++f) mx = fmaxf(mx, l[f]);
        float sum = 0.0f;
        for (int f = 0; f < F; ++f) sum += expf(l[f] - mx);
        for (int f = 0; f < F; ++f) l[f] = expf(l[f] - mx) / sum;
      }
      __syncthreads();

      // out[s, c] = sum_f a2[s, head(c), f] xs[s, f, c] for the group's
      // channels, 8 channels a thread (their scaled q2 is in registers)
      const int c8n = nh * HD / 8;
      for (int i = tid; i < BQ * c8n; i += THREADS) {
        const int r = i / c8n, c8 = h0 * HD + (i % c8n) * 8;
        if (r >= rows) continue;
        const float* a2 = LG + (r * HPG + (c8 / HD - h0)) * MAX_F;
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = 0.0f;
        for (int f = 0; f < F; ++f) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              xs + ((row_base + r) * F + f) * C + c8);
          const bf16* xv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            o[j] = fmaf(a2[f], __bfloat162float(xv[j]), o[j]);
        }
        uint4 packed;
        bf16* ov = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) ov[j] = __float2bfloat16(o[j]);
        *reinterpret_cast<uint4*>(out + (row_base + r) * C + c8) = packed;
      }
      __syncthreads();  // LG is rewritten by the next group
    }
  }
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
