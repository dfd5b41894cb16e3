// The tiled bf16 GEMM of the trajectory-attention kernels, with an
// optional row gather, bias and scaled second output: the q2 GEMM of the
// forward versions 4, 3 and 7 (trajectory_block.cu) and the k2v and q2
// GEMMs of versions 5 and 6 (trajectory_k2v.cuh), and the widths those
// sources share. Their attention stages run on wgmma and TMA
// (space_stage_core.cuh, trajectory_k2v.cuh). ops/_build.py hashes this
// header with every source.

#pragma once

#include "mma_sm90.cuh"

namespace {

constexpr int HD = 64;           // head dim
constexpr int MAX_F = 8;         // frames; also the stride of the logits
constexpr int MAX_HEADS = 16;

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
