// The second half of the one-launch trajectory-core forwards
// (trajectory_block_v3.cu, trajectory_block_v7.cu): for one block of up to
// S2_ROWS query rows of one batch row, after its stage 1 has written the
// block's rows of xs [B, S, F, C],
//
//   stage2_q2: x_diag = xs[b, s, s / N] is gathered as 128 x 32 tiles are
//     copied in (cp.async) and multiplied with Wq2 streamed in k-steps of
//     32, one 128-column tile at a time (mma.sync m16n8k16). q2 = acc + bq2
//     goes to q2 [B, S, C] in bf16 unscaled, as the backward kernel reads
//     it, and round((acc + bq2) * scale), the TPU kernels' stage-2 query, to
//     the block's own rows of out, which is free until stage 2 writes each
//     head's channels there last. A query block that crosses a frame
//     boundary gathers each row's own frame.
//   stage2_core: over groups of up to HPG = 3 heads (the warp's query
//     fragments for a group are read back from out into registers): for
//     each 32-channel chunk of xs (all F frames) and the matching rows of
//     Wk2 (cp.async, double-buffered), per head the chunk of g_h = q2_h .
//     Wk2_h^T by mma.sync, kept in float32 (the TPU kernels' fouter form
//     does not round it), is dotted with the chunk for every frame into the
//     row's logits. Then a2 = softmax over frames in float32, and out =
//     round(sum_f a2_f xs_f) for the group's channels. bk2 is constant over
//     frames and drops out.
//
// Both run with S2_THREADS threads (8 warps of 16 rows) on the dynamic
// shared memory the caller passes, stage2_smem(F) bytes at least:
//   q2:      two A tiles [128][40] and two Wq2 tiles [32][136] bf16, 37 KB;
//   stage 2: two buffers of xs [128][F * 40 + 8] + Wk2 [32][200] bf16, and
//            the logits [128][3][8] float, 201 KB at F = 8.
// xs, q2 and out are written and read back by the same block, so they are
// read with plain (coherent) loads, never through the read-only path. Call
// each after a __syncthreads() that follows the block's last write of what
// it reads (stage 1's xs; stage2_q2's out). ops/_build.py hashes this
// header with every source.

#pragma once

#include "trajectory_core.cuh"

namespace {

constexpr int S2_ROWS = 128;      // query rows per block (8 warps x 16)
constexpr int S2_THREADS = 256;
constexpr int S2_CH = 32;         // stage-2 xs channels per chunk
constexpr int LDC = S2_CH + 8;
constexpr int HPG = 3;            // stage-2 heads per group
constexpr int LDW = HPG * HD + 8;

__host__ __device__ inline size_t stage2_xc_elems(int F) {  // one buffer
  return (size_t)S2_ROWS * (F * LDC + 8);
}

// the shared memory of stage2_q2 and stage2_core, the larger of the two
__host__ __device__ inline size_t stage2_smem(int F) {
  const size_t gemm = (size_t)(2 * GM * LDA_G + 2 * GK * LDB_G) * sizeof(bf16);
  const size_t s2 = 2 * (stage2_xc_elems(F) + (size_t)S2_CH * LDW) * sizeof(bf16) +
                    (size_t)S2_ROWS * HPG * MAX_F * sizeof(float);
  return gemm > s2 ? gemm : s2;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// q2 = x_diag . Wq2 + bq2 for query rows s0 .. s0 + rows - 1 of the batch
// row whose first of them is row_base = b * S + s0
__device__ __forceinline__ void stage2_q2(
    unsigned char* smem, const bf16* xs, const bf16* __restrict__ wq2,
    const bf16* __restrict__ bq2, bf16* q2, bf16* out, int s0, int rows,
    size_t row_base, int F, int N, int C, float scale) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][GM * LDA_G]
  bf16* Bs = As + 2 * GM * LDA_G;            // [2][GK * LDB_G]
  const int wm = warp / 4, wn = warp % 4;    // warp tile rows wm*64, cols wn*32
  // each thread copies two 16-byte pieces of A and of B per k-step; A row
  // r is the own-frame aggregate of query row s0 + r
  const bf16* arow[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = (tid + j * S2_THREADS) >> 2, s = s0 + r;
    arow[j] = r < rows ? xs + ((row_base + r) * F + s / N) * C : nullptr;
  }
  for (int n0 = 0; n0 < C; n0 += GN) {
    auto load_tile = [&](int stage, int k0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = tid + j * S2_THREADS;
        bf16* dst = As + stage * GM * LDA_G + (i >> 2) * LDA_G + (i & 3) * 8;
        if (arow[j]) cp_async16(dst, arow[j] + k0 + (i & 3) * 8);
        else zero16(dst);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = tid + j * S2_THREADS;
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

// stage 2 for the block's rows: the scaled q2 that stage2_q2 parked in out
// is read back and out is overwritten with the trajectory core's output
__device__ __forceinline__ void stage2_core(
    unsigned char* smem, const bf16* xs, const bf16* __restrict__ wk2,
    bf16* out, int rows, size_t row_base, int F, int C, int heads) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int XCR = F * LDC + 8;  // the extra 8 spread a row's reads over banks
  // buffer j: xs chunk [S2_ROWS][XCR], then Wk2 chunk [S2_CH][LDW]; then LG
  const size_t s2buf = stage2_xc_elems(F) + (size_t)S2_CH * LDW;
  auto xcb = [&](int j) { return reinterpret_cast<bf16*>(smem) + j * s2buf; };
  auto wkb = [&](int j) { return xcb(j) + stage2_xc_elems(F); };
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
      for (int i = tid; i < S2_ROWS * F * (S2_CH / 8); i += S2_THREADS) {
        const int r = i / (F * (S2_CH / 8)), rem = i % (F * (S2_CH / 8));
        const int f = rem / (S2_CH / 8), c8 = (rem % (S2_CH / 8)) * 8;
        bf16* dst = xd + r * XCR + f * LDC + c8;
        if (r < rows) cp_async16(dst, xs + ((row_base + r) * F + f) * C + cc + c8);
        else zero16(dst);
      }
      const int w8 = nh * HD / 8;
      for (int i = tid; i < S2_CH * w8; i += S2_THREADS) {
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
    for (int p = tid; p < S2_ROWS * nh; p += S2_THREADS) {
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
    for (int i = tid; i < S2_ROWS * c8n; i += S2_THREADS) {
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

}  // namespace
