// The v5 and v6 forward kernels of the trajectory core share everything but
// their last step; this header holds that shared part (ops/_build.py hashes
// it with every source). Both reassociate the stage-2 logits through
// k2v = V . Wk2 (the TPU kernels _fused_kernel_v5 / _fused_kernel_v6 in
// focus_tpu/ops/pallas/trajectory_block.py):
//
//   M_h[q, n]  = q2_h[q] . k2v_h[n]                  (per head, all F x N keys)
//   l2_h[q, f] = sum_{n in f} p_h[q, n] M_h[q, n] / s_h[q, f] * scale
//
// with p_h the head's unnormalised stage-1 weights (here exp(logit - the
// row's max in frame f), a true per-frame max where the TPU kernels clamp
// exp2 with no max) and s_h their per-frame sums. Both p and s come from the
// same shifted weights, so the shift cancels. Note what the identity needs:
// q2_h . (xs_f . Wk2)_h mixes every head's channels of xs_f, each formed
// with its own head's weights, while l2_h weights all of V . Wk2 with head
// h's; the two agree only where every head's stage-1 weights agree (one
// head, or uniform attention). The variants compute l2_h as the TPU kernels
// do, and so differ from version 4 and the plain trajectory core elsewhere.
//
// Launches of one call, on one stream (every launch is counted):
//   1. k2v[b] = V_b . Wk2 ([F * N, C] x [C, C] per batch row), the tiled
//      GEMM; the TPU kernels form it inside the kernel once per batch row.
//   2. stage 1: v6 writes xs [B, S, F, C] as version 4 does; v5 writes only
//      the own-frame aggregates x_diag [B, S, C] (DIAG), so xs never exists.
//   3. q2 = x_diag . Wq2 + bq2 (the tiled GEMM; v6 gathers x_diag from xs).
//   4. the stage-2 kernel below, one block per (batch row, head, 128-query
//      tile), 8 warps of 16 rows. x_diag needs every head before q2 exists,
//      so q2 crosses a launch boundary here, as it does in version 4;
//      within a head nothing does. Pass A over the frames (K_f and k2v_f
//      tiles double-buffered in shared memory) recomputes the head's logits
//      with mma.sync, keeps each row's max and sum per frame, and forms
//      sum p M / s from a 16-key M tile at a time, so M never leaves
//      registers. a2 = softmax over frames, in float32. Then
//        v6: out_h = sum_f a2_f xs_f,h (xs read back from device memory);
//        v5: pass B recomputes the logits and the same p (the row maxima are
//            kept) and multiplies the bf16 weights p a2_f / s_f into V_h on
//            the tensor cores: out_h = sum over all F x N keys.
// The TPU kernels keep every head's p in VMEM between the two halves (25 MB
// at a 256-row block); one head's fits in no SM's shared memory, so the
// stage-2 kernel recomputes the logits (v5 twice) instead.

#pragma once

#include "trajectory_core.cuh"

namespace {

// shared memory: stage 1's layout, the second tile of each buffer holding
// k2v (pass A) or V (pass B), then three float [S1_ROWS][MAX_F] tables: the
// rows' per-frame maxima, sums, and stage-2 logits (overwritten by a2, or
// by a2 / s for v5)
template <int KT>
constexpr size_t k2v_stage2_smem() {
  return stage1_smem<KT>() + 3 * S1_ROWS * MAX_F * sizeof(float);
}

template <int KT, bool FOLD>
__global__ void __launch_bounds__(S1_THREADS) traj_k2v_stage2_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kf,
    const bf16* __restrict__ vf, const bf16* __restrict__ k2v,
    const bf16* __restrict__ q2, const bf16* __restrict__ xs,
    bf16* __restrict__ out, int S, int F, int N, int C, float scale) {
  constexpr int NP = 16 * KT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* K0 = reinterpret_cast<bf16*>(smem);
  bf16* X0 = K0 + stage1_krows<KT>() * LDH;
  bf16* K1 = X0 + NP * LDH;
  bf16* X1 = K1 + NP * LDH;
  float* MX = reinterpret_cast<float*>(smem + stage1_smem<KT>());
  float* SS = MX + S1_ROWS * MAX_F;
  float* L2 = SS + S1_ROWS * MAX_F;

  const int s0 = blockIdx.x * S1_ROWS, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int hoff = head * HD;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's block rows

  // the Q and q2 tiles ([B, S, C] both), staged through K0 into A fragments
  auto stage_tile = [&](const bf16* src, uint32_t (&frag)[HD / 16][4]) {
    for (int i = tid; i < S1_ROWS * 8; i += S1_THREADS) {
      const int r = i >> 3, c8 = (i & 7) * 8, s = s0 + r;
      bf16* dst = K0 + r * LDH + c8;
      if (s < S) copy16(dst, src + ((size_t)b * S + s) * C + hoff + c8);
      else zero16(dst);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      ldmatrix_x4(frag[ks], K0 + (warp * 16 + (lane & 7) +
                                  8 * ((lane >> 3) & 1)) * LDH +
                                ks * 16 + 8 * (lane >> 4));
    __syncthreads();
  };
  uint32_t qa[HD / 16][4], q2a[HD / 16][4];
  stage_tile(q, qa);
  stage_tile(q2, q2a);

  // padding key rows stay zero in every buffer
  for (int i = tid; i < (NP - N) * 8; i += S1_THREADS) {
    const int r = N + (i >> 3), c8 = (i & 7) * 8;
    zero16(K0 + r * LDH + c8);
    zero16(X0 + r * LDH + c8);
    zero16(K1 + r * LDH + c8);
    zero16(X1 + r * LDH + c8);
  }
  // frame f's K tile and the same rows of ``second`` (k2v or V, both laid
  // out [B, F, N, C]) into buffer f % 2
  auto issue_frame = [&](int f, const bf16* second) {
    const size_t kv0 = ((size_t)b * F + f) * N * C + hoff;
    bf16* Kd = (f & 1) ? K1 : K0;
    bf16* Xd = (f & 1) ? X1 : X0;
    for (int i = tid; i < N * 8; i += S1_THREADS) {
      const int r = i >> 3, c8 = (i & 7) * 8;
      cp_async16(Kd + r * LDH + c8, kf + kv0 + (size_t)r * C + c8);
      cp_async16(Xd + r * LDH + c8, second + kv0 + (size_t)r * C + c8);
    }
    cp_async_commit();
  };
  auto wait_frame = [&](int f, const bf16* second) {
    if (f + 1 < F) {
      issue_frame(f + 1, second);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // frame f's tiles have landed for every thread
  };
  // this warp's 16 rows' logits against frame f's keys times scale, the
  // pad keys at -inf: tile n holds keys 8n + 2t + {0, 1} of rows g
  // (elements 0, 1) and g + 8 (2, 3)
  auto frame_logits = [&](const bf16* Ks, float (&sacc)[2 * KT][4]) {
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
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * t + (e & 1);
        sacc[n][e] = key < N ? sacc[n][e] * scale : -INFINITY;
      }
  };
  auto quad_sum = [](float v) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };

  // ---- pass A: per frame, the row max and sum, and sum p M / s ----------
  issue_frame(0, k2v);
  for (int f = 0; f < F; ++f) {
    wait_frame(f, k2v);
    const bf16* Ks = (f & 1) ? K1 : K0;
    const bf16* Xs = (f & 1) ? X1 : X0;
    float sacc[2 * KT][4];
    frame_logits(Ks, sacc);
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n) {
      m0 = fmaxf(m0, fmaxf(sacc[n][0], sacc[n][1]));
      m1 = fmaxf(m1, fmaxf(sacc[n][2], sacc[n][3]));
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
        const float p = __expf(sacc[n][e] - (e < 2 ? m0 : m1));  // pads: 0
        sacc[n][e] = p;
        if (e < 2) l0 += p;
        else l1 += p;
      }
    // M = q2_h . k2v_h^T, one 16-key tile at a time, weighted by p
    float pm0 = 0.0f, pm1 = 0.0f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float ma[4] = {0.0f, 0.0f, 0.0f, 0.0f}, mb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Xs + (j * 16 + (lane & 7) + 8 * (lane >> 4)) * LDH +
                            ks * 16 + 8 * ((lane >> 3) & 1));
        mma_16816(ma, q2a[ks], kb[0], kb[1]);
        mma_16816(mb, q2a[ks], kb[2], kb[3]);
      }
      pm0 += sacc[2 * j][0] * ma[0] + sacc[2 * j][1] * ma[1] +
             sacc[2 * j + 1][0] * mb[0] + sacc[2 * j + 1][1] * mb[1];
      pm1 += sacc[2 * j][2] * ma[2] + sacc[2 * j][3] * ma[3] +
             sacc[2 * j + 1][2] * mb[2] + sacc[2 * j + 1][3] * mb[3];
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    pm0 = quad_sum(pm0);
    pm1 = quad_sum(pm1);
    if (t == 0) {
      MX[r0 * MAX_F + f] = m0;
      MX[r1 * MAX_F + f] = m1;
      SS[r0 * MAX_F + f] = l0;
      SS[r1 * MAX_F + f] = l1;
      L2[r0 * MAX_F + f] = pm0 / l0 * scale;
      L2[r1 * MAX_F + f] = pm1 / l1 * scale;
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copy
  }

  // ---- a2 = softmax over frames (float32); v5 keeps a2 / s --------------
  if (tid < S1_ROWS) {
    float* l = L2 + tid * MAX_F;
    float mx = -INFINITY;
    for (int f = 0; f < F; ++f) mx = fmaxf(mx, l[f]);
    float sum = 0.0f;
    for (int f = 0; f < F; ++f) sum += expf(l[f] - mx);
    for (int f = 0; f < F; ++f) {
      const float a2 = expf(l[f] - mx) / sum;
      l[f] = FOLD ? a2 / SS[tid * MAX_F + f] : a2;
    }
  }
  __syncthreads();

  if constexpr (!FOLD) {
    // ---- v6: out_h = sum_f a2_f xs_f,h, 8 channels a thread -------------
    for (int i = tid; i < S1_ROWS * (HD / 8); i += S1_THREADS) {
      const int r = i / (HD / 8), c8 = hoff + (i % (HD / 8)) * 8;
      const int s = s0 + r;
      if (s >= S) continue;
      const float* a2 = L2 + r * MAX_F;
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = 0.0f;
      for (int f = 0; f < F; ++f) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            xs + (((size_t)b * S + s) * F + f) * C + c8);
        const bf16* xv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = fmaf(a2[f], __bfloat162float(xv[j]), o[j]);
      }
      uint4 packed;
      bf16* ov = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) ov[j] = __float2bfloat16(o[j]);
      *reinterpret_cast<uint4*>(out + ((size_t)b * S + s) * C + c8) = packed;
    }
  } else {
    // ---- v5, pass B: out_h = sum over all keys of bf16(p a2_f / s_f) V --
    float oacc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
    issue_frame(0, vf);
    for (int f = 0; f < F; ++f) {
      wait_frame(f, vf);
      const bf16* Ks = (f & 1) ? K1 : K0;
      const bf16* Vs = (f & 1) ? X1 : X0;
      float sacc[2 * KT][4];
      frame_logits(Ks, sacc);  // the same values as in pass A
      const float mx0 = MX[r0 * MAX_F + f], mx1 = MX[r1 * MAX_F + f];
      const float c0 = L2[r0 * MAX_F + f], c1 = L2[r1 * MAX_F + f];
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[n][e] = e < 2 ? __expf(sacc[n][e] - mx0) * c0
                             : __expf(sacc[n][e] - mx1) * c1;
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
          ldmatrix_x4_trans(vb, Vs + (j * 16 + (lane & 7) +
                                      8 * ((lane >> 3) & 1)) * LDH +
                                    dp * 16 + 8 * (lane >> 4));
          mma_16816(oacc[2 * dp], pa, vb[0], vb[1]);
          mma_16816(oacc[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
      __syncthreads();  // this buffer is refilled by the next iteration
    }
    const int row0 = s0 + r0, row1 = s0 + r1;
    bf16* out0 = out + ((size_t)b * S + row0) * C + hoff + 2 * t;
    bf16* out1 = out + ((size_t)b * S + row1) * C + hoff + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(out0 + n * 8) =
            __floats2bfloat162_rn(oacc[n][0], oacc[n][1]);
      if (row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(out1 + n * 8) =
            __floats2bfloat162_rn(oacc[n][2], oacc[n][3]);
    }
  }
}

template <int KT, bool FOLD>
cudaError_t launch_k2v_stage2_kt(const bf16* q, const bf16* kf,
                                 const bf16* vf, const bf16* k2v,
                                 const bf16* q2, const bf16* xs, bf16* out,
                                 int B, int S, int F, int N, int C, int heads,
                                 float scale, cudaStream_t st) {
  constexpr size_t smem = k2v_stage2_smem<KT>();
  cudaError_t err = cudaFuncSetAttribute(
      traj_k2v_stage2_kernel<KT, FOLD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + S1_ROWS - 1) / S1_ROWS, heads, B);
  traj_k2v_stage2_kernel<KT, FOLD><<<grid, S1_THREADS, smem, st>>>(
      q, kf, vf, k2v, q2, xs, out, S, F, N, C, scale);
  return cudaGetLastError();
}

template <bool FOLD>
cudaError_t launch_k2v_stage2(const bf16* q, const bf16* kf, const bf16* vf,
                              const bf16* k2v, const bf16* q2, const bf16* xs,
                              bf16* out, int B, int S, int F, int N, int C,
                              int heads, float scale, cudaStream_t st) {
  const int kt = (N + 15) / 16;
  if (kt <= 4)
    return launch_k2v_stage2_kt<4, FOLD>(q, kf, vf, k2v, q2, xs, out, B, S,
                                         F, N, C, heads, scale, st);
  if (kt <= 8)
    return launch_k2v_stage2_kt<8, FOLD>(q, kf, vf, k2v, q2, xs, out, B, S,
                                         F, N, C, heads, scale, st);
  if (kt <= 13)
    return launch_k2v_stage2_kt<13, FOLD>(q, kf, vf, k2v, q2, xs, out, B, S,
                                          F, N, C, heads, scale, st);
  return launch_k2v_stage2_kt<16, FOLD>(q, kf, vf, k2v, q2, xs, out, B, S, F,
                                        N, C, heads, scale, st);
}

// The four launches of one v5 (V5) or v6 call; ``agg`` is x_diag [B, S, C]
// for v5 and xs [B, S, F, C] for v6. Counts each launch made into
// *launched and returns the first cudaError_t met.
template <bool V5>
int traj_core_k2v(const void* q, const void* kf, const void* vf,
                  const void* wq2, const void* bq2, const void* wk2,
                  void* k2v, void* agg, void* q2, void* out, int* launched,
                  int B, int S, int F, int N, int C, int heads, float scale,
                  void* stream) {
  *launched = 0;
  if (B <= 0 || N <= 0 || N > MAX_NP || F <= 0 || F > MAX_F || S != F * N ||
      heads <= 0 || heads > MAX_HEADS || C != heads * HD || C % GN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* kf_ = static_cast<const bf16*>(kf);
  const bf16* vf_ = static_cast<const bf16*>(vf);
  bf16* k2v_ = static_cast<bf16*>(k2v);
  bf16* agg_ = static_cast<bf16*>(agg);
  bf16* q2_ = static_cast<bf16*>(q2);

  cudaError_t err = launch_gemm(vf_, static_cast<const bf16*>(wk2), nullptr,
                                k2v_, B * F * N, 1, 1, 1, C, st);
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  err = launch_stage1<V5>(q_, kf_, vf_, agg_, B, S, F, N, C, heads, scale,
                          st);
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  // v5: x_diag rows as they are; v6: gathered from xs as version 4 does
  err = launch_gemm(agg_, static_cast<const bf16*>(wq2),
                    static_cast<const bf16*>(bq2), q2_, B * S, V5 ? 1 : S,
                    V5 ? 1 : F, V5 ? 1 : N, C, st);
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  err = launch_k2v_stage2<V5>(q_, kf_, vf_, k2v_, q2_, V5 ? nullptr : agg_,
                              static_cast<bf16*>(out), B, S, F, N, C, heads,
                              scale, st);
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

}  // namespace
