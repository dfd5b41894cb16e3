// The trajectory core's forward versions 5 and 6 for Hopper (sm_90a), one
// design with a flag (trajectory_block_v5.cu, trajectory_block_v6.cu).
// Both read the stage-2 logits off k2v = V . Wk2, as the TPU kernels
// _fused_kernel_v5 / _fused_kernel_v6 (focus_tpu/ops/pallas/
// trajectory_block.py) do:
//
//   M_h[q, n]  = q2_h[q] . k2v_h[n]                  (per head, all F x N keys)
//   l2_h[q, f] = sum_{n in f} p_h[q, n] M_h[q, n] / s_h[q, f] * scale
//
// with p_h the head's unnormalised stage-1 weights and s_h their per-frame
// sums. Note what the identity needs: q2_h . (xs_f . Wk2)_h mixes every
// head's channels of xs_f, each formed with its own head's weights, while
// l2_h weights all of V . Wk2 with head h's; the two agree only where every
// head's stage-1 weights agree (one head, or uniform attention). The
// variants compute l2_h as the TPU kernels do, and so differ from version 4
// and the plain trajectory core elsewhere.
//
// The card never forms M. In exact arithmetic l2_h[q, f] = q2_h[q] .
// y_f,h[q] with y_f,h = sum_{n in f} (p / s) k2v_h[n]: the frame's
// normalised stage-1 weights applied to a second value stream, k2v, beside
// V. So one pass over the frames forms each frame's logits once, O_f = P .
// V_f and Y_f = P . k2v_f from the same bf16 P, l2_f as a 64-wide row dot,
// and the softmax over frames online; it recomputes no logits.
//
// Launches of one call, on one stream (each one counted):
//   1. k2v[b] = V_b . Wk2 ([F N, C] x [C, C] per batch row), the tiled GEMM
//      of trajectory_core.cuh; the TPU kernels form it inside the kernel.
//   2. the own-frame aggregates x_diag [B, S, C]: space_stage_core.cuh's
//      wgmma / TMA kernel in its own-frame mode (a 128-query unit visits
//      only the frames its rows lie in, one or two at N = 196; only own-
//      frame rows are stored). v6 parks x_diag in out until launch 3 has
//      read it; v5 has a buffer of its own.
//   3. q2 = x_diag . Wq2 + bq2, the tiled GEMM. x_diag needs every head
//      before q2 exists, so q2 crosses a launch boundary here.
//   4. the pass (k2v_pass_kernel below): a persistent grid of one block an
//      SM walking (b, head, 128-query tile) units head-major, as the space
//      stage does, with its producer / consumer shape. A frame slot holds
//      K_f, V_f and k2v_f of the head (three TMA boxes of [NP, 64] at
//      channel 64 h). A consumer warpgroup of 64 rows, per frame: the
//      logits by wgmma m64nNPk16, the true max-subtracted softmax with P
//      normalised and rounded to bf16 in registers (the space stage's code,
//      ss_frame_softmax, so the own frame's O_f is x_diag's bits), Y_f and
//      O_f by two m64n64k16 chains with A from those registers, l2_f = q2_h
//      . Y_f * scale by a quad-lane row dot against the rows' q2 (read into
//      registers once a unit), and the online softmax over frames: a
//      running max and sum and an accumulator of the mixed output rescaled
//      per frame. v6 mixes the rounded xs_f = bf16(O_f) and stores it by
//      TMA (a staging tile a frame, as the space stage stores); v5 mixes
//      the float32 O_f and stores no xs. out leaves once a unit.
//
// Registers: P is not held across a turn of the two warpgroups, as the
// space stage holds it, since the logits (104 a thread at NP = 208), P
// (52), O, Y and the accumulator (32 each) would pass setmaxnreg's 232. So
// a frame takes two turns (named barriers 3 and 4), one for the logits and
// one for both products, and one warpgroup's products run while the
// other's softmax or epilogue does. Shared memory (k2v_pass_smem_bytes): two
// 78 KB slots at NP = 208 beside two Q tiles and two staging tiles a
// warpgroup (222 KB); at NP = 256 two 96 KB slots with one Q tile and one
// staging tile a warpgroup (226 KB).
//
// Chunked form (SS_MAX_NP < N <= SS_MAX_KEYS, the 336 crop's N = 441 and
// 445): a frame's keys go in two chunks of ss_chunk_keys(N) (224 up to N =
// 448, else 256), as in the stage-1 kernel's chunked form. Launch 2 is the
// stage-1 body's chunked form in its own-frame mode. The pass's slot holds
// K_c, V_c and k2v_c of one chunk (86 KB at 224 keys, 96 KB at 256: two
// slots with one Q tile and one staging tile a warpgroup, 207 or 226 KB),
// and a chunk takes the two turns a frame takes at N <= 256: its logits,
// then P packed unnormalised against the running max (ss_chunk_weights)
// and O_c = P . V_c, Y_c = P . k2v_c accumulated onto the frame's sums,
// which a later chunk first rescales by exp(m_old - m_new) with l. After
// the frame's last chunk O_f and Y_f are scaled by 1 / l, then l2, the
// frame softmax and the mix run as at N <= 256. The arithmetic of O_f is
// the own-frame launch's (the same ss_chunk_weights, product order and 1 /
// l), so v6's own-frame xs is still x_diag's bits. The two accumulators
// beside the frame's logits leave no registers for q2, which this form
// reads at each frame's end. The weights are rounded unnormalised here,
// where the pass normalises them before the rounding at N <= 256.
//
// Bounds on this card at B = 8, S = 1568, N = 196, 12 heads: the function
// in this form needs 120.5 GFLOP (the k2v and q2 GEMMs 14.8 each, the pass
// 90.9), 0.1219 ms at 989 TFLOP/s (chip_smoke.py k2v_flops); launch 2 adds
// 7.6 that the pass does again. The function of version 4 is bound at
// 0.0930 ms. The M-form of the TPU kernels did 150 (v6) and 158 (v5)
// GFLOP. ops/_build.py hashes this header with every source.

#pragma once

#include <type_traits>

#include "trajectory_core.cuh"
#include "space_stage_core.cuh"

namespace {

// Q tiles, and staging tiles a warpgroup: two of each, or one at NP = 256,
// where two frame slots of K, V and k2v leave room for no more
__host__ __device__ constexpr int kp_slots(int np) { return np > 208 ? 1 : 2; }

__host__ __device__ constexpr int kp_stage_bytes(int np) {
  return 3 * np * SS_ROW_BYTES;  // K_f, V_f and k2v_f
}

__host__ __device__ constexpr int kp_fixed_bytes(int np) {
  return SS_ALIGN + kp_slots(np) * SS_Q_BYTES +
         SS_WG * kp_slots(np) * SS_OUT_BYTES + SS_BAR_BYTES;
}

__host__ __device__ constexpr int kp_stages(int np) {
  return (SS_SMEM_LIMIT - kp_fixed_bytes(np)) / kp_stage_bytes(np) <
                 SS_MAX_STAGES
             ? (SS_SMEM_LIMIT - kp_fixed_bytes(np)) / kp_stage_bytes(np)
             : SS_MAX_STAGES;
}

__host__ __device__ constexpr int k2v_pass_smem_bytes(int np) {
  return kp_fixed_bytes(np) + kp_stages(np) * kp_stage_bytes(np);
}

static_assert(kp_stages(208) >= 2 && kp_stages(SS_MAX_NP) >= 2 &&
                  kp_stages(224) >= 2,
              "two frame (or chunk) slots at N <= 512");

// launch 2: the own-frame aggregates x_diag [B, S, C] on the space stage's
// kernel body in its own-frame mode (CH > 1: its chunked form, NP keys a
// chunk)
template <int NP, int CH>
__global__ void __launch_bounds__(SS_THREADS, 1) own_frame_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* x_diag, int BH,
    int heads, int S, int F, int N, float scale_log2e) {
  space_stage_body<NP, false, true, CH>(&q_map, &k_map, &v_map, &k_map,
                                        x_diag, BH, heads, S, F, N,
                                        scale_log2e);
}

// q [B, S, C], kf / vf [B, F, N, C] -> x_diag [B, S, C]: row s's aggregate
// over its own frame s / N alone, bit-equal to the space stage's row s of
// that frame
template <int NP, int CH>
cudaError_t launch_own_frame(const bf16* q, const bf16* kf, const bf16* vf,
                             bf16* x_diag, int B, int heads, int S, int F,
                             int N, float scale, cudaStream_t st) {
  CUtensorMap qm, kvm[2];
  const bf16* kv[2] = {kf, vf};
  cudaError_t e = ss_input_maps<NP>(q, &qm, 2, kv, kvm, B, heads, S, F, N);
  if (e != cudaSuccess) return e;
  constexpr int smem = ss_smem_bytes(NP, CH);
  static const cudaError_t attr = cudaFuncSetAttribute(
      own_frame_kernel<NP, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  e = ss_sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int units = B * heads * ((S + SS_ROWS - 1) / SS_ROWS);
  const int grid = units < sms ? units : sms;
  own_frame_kernel<NP, CH><<<grid, SS_THREADS, smem, st>>>(
      qm, kvm[0], kvm[1], x_diag, B * heads, heads, S, F, N,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// q [B, S, C] and q2 [B, S, C] (unscaled, with its bias); K, V, k2v
// [B F, N, C] through their maps; v6 (!V5) writes xs [B, S, F, C] through
// xs_map; out [B, S, C]. CH > 1: the chunked form, NP keys a chunk
template <int NP, bool V5, int CH>
__global__ void __launch_bounds__(SS_THREADS, 1) k2v_pass_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap y_map,
    const __grid_constant__ CUtensorMap xs_map, const bf16* __restrict__ q2,
    bf16* __restrict__ out, int BH, int heads, int S, int F, int N,
    float scale_log2e) {
  constexpr int KV_TILE = NP * SS_ROW_BYTES;
  constexpr int STAGES = kp_stages(NP);
  constexpr int QS = kp_slots(NP), OS = QS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((SS_ALIGN - (cvta_smem(smem_raw) & (SS_ALIGN - 1))) &
                  (SS_ALIGN - 1));
  unsigned char* kv = smem;  // slot s: K, V, then k2v
  unsigned char* qbuf = kv + STAGES * 3 * KV_TILE;
  unsigned char* obuf = qbuf + QS * SS_Q_BYTES;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(obuf + SS_WG * OS * SS_OUT_BYTES);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + SS_MAX_STAGES;
  uint64_t* q_full = bars + 2 * SS_MAX_STAGES;
  uint64_t* q_empty = q_full + 2;

  const int tiles = (S + SS_ROWS - 1) / SS_ROWS;
  const int units = BH * tiles;  // BH = B x heads: (b, head) pairs
  const int C = heads * SS_HD;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 128 * SS_WG);
    }
    for (int s = 0; s < QS; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 128 * SS_WG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * SS_WG) {  // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(SS_PRODUCER_REGS));
    if (tid == 128 * SS_WG) {
      int stage = 0, u = 0;
      uint32_t phase = 0;
      for (int unit = blockIdx.x; unit < units; unit += gridDim.x, ++u) {
        const int bh = unit / tiles, s0 = (unit % tiles) * SS_ROWS;
        const int b = bh / heads, c0 = (bh % heads) * SS_HD;
        const int qs = u % QS;
        mbar_wait(&q_empty[qs], ((u / QS) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qs], SS_Q_BYTES);
        tma_load_3d(qbuf + qs * SS_Q_BYTES, &q_map, &q_full[qs], c0, s0, b);
        for (int f = 0; f < F; ++f)
          for (int c = 0; c < CH; ++c) {  // chunk c: keys from c NP
            mbar_wait(&kv_empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&kv_full[stage], 3 * KV_TILE);
            unsigned char* kd = kv + stage * 3 * KV_TILE;
            tma_load_3d(kd, &k_map, &kv_full[stage], c0, c * NP, b * F + f);
            tma_load_3d(kd + KV_TILE, &v_map, &kv_full[stage], c0, c * NP,
                        b * F + f);
            tma_load_3d(kd + 2 * KV_TILE, &y_map, &kv_full[stage], c0, c * NP,
                        b * F + f);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(SS_CONSUMER_REGS));
  // a consumer warpgroup: rows 16 warp + g and + 8 of its 64, in the
  // accumulators' layout (element 4j + e: key / channel 8j + 2 t4 + (e & 1),
  // the second row for e >= 2)
  const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const bool storer = wtid == 0;
  unsigned char* my_out = obuf + wg * OS * SS_OUT_BYTES;
  // The two warpgroups take turns at the tensor cores (named barriers 3 and
  // 4), two turns a frame: one issues the logits, the other P . k2v and P .
  // V, so one warpgroup's products run while the other's softmax or its
  // stage-2 epilogue does.
  if (wg == 1) named_barrier_arrive(3, 256);  // warpgroup 0 goes first
  int stage = 0, oslot = 0, u = 0;
  uint32_t phase = 0;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x, ++u) {
    const bool last_unit = unit + (int)gridDim.x >= units;
    const int bh = unit / tiles;
    const int b = bh / heads, c0 = (bh % heads) * SS_HD;
    const int row0 = (unit % tiles) * SS_ROWS + wg * 64;  // this warpgroup's
    const int s_0 = row0 + r0, s_1 = row0 + r1;            // this thread's
    const int qs = u % QS;
    // q2 of the thread's two rows at its 16 channels of the head, as bf16
    // pairs (rows past S: zero; they are not stored), read once a unit, or
    // in the chunked form at each frame's end
    uint32_t qa[SS_HD / 8], qb[SS_HD / 8];
    auto load_q2 = [&]() {
      const bf16* p0 = q2 + ((size_t)b * S + s_0) * C + c0 + 2 * t4;
      const bf16* p1 = p0 + (size_t)8 * C;
#pragma unroll
      for (int j = 0; j < SS_HD / 8; ++j) {
        qa[j] = s_0 < S ? ldg32(p0 + 8 * j) : 0u;
        qb[j] = s_1 < S ? ldg32(p1 + 8 * j) : 0u;
      }
    };
    if constexpr (CH == 1) load_q2();
    mbar_wait(&q_full[qs], (u / QS) & 1);
    const uint64_t dq = wgmma_desc_sw128(
        qbuf + qs * SS_Q_BYTES + wg * SS_WG_ROWS_BYTES, 16, 1024);
    // the online softmax over frames, in log2 units: running max, sum and
    // the mixed output of the two rows
    float mx0 = -INFINITY, mx1 = -INFINITY, sum0 = 0.f, sum1 = 0.f;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    for (int f = 0; f < F; ++f) {
      // Y_f = P . k2v_f and O_f = P . V_f (in the chunked form summed over
      // the frame's chunks, with the stage-1 softmax's running max and sum)
      float yacc[32], oacc[32];
      float rm0 = 0.f, rm1 = 0.f, rl0 = 0.f, rl1 = 0.f;
      for (int c = 0; c < CH; ++c) {
        const bool last = f == F - 1 && c == CH - 1;
        unsigned char* slot = kv + stage * 3 * KV_TILE;
        float sacc[NP / 2];
        named_barrier(3 + wg, 256);  // this warpgroup's turn: the logits
        mbar_wait(&kv_full[stage], phase);
        wgmma_fence();
        {  // logits: 4 k-steps of 16 channels, 32 bytes along a row
          const uint64_t dk = wgmma_desc_sw128(slot, 16, 1024);
#pragma unroll
          for (int k = 0; k < SS_HD / 16; ++k)
            wgmma_ss<NP>(sacc, dq + 2 * k, dk + 2 * k, k);
        }
        wgmma_commit();
        named_barrier_arrive(3 + (1 - wg), 256);  // the other's turn
        wgmma_wait<0>();
        reg_fence(sacc);
        if (last) mbar_arrive(&q_empty[qs]);  // Q read for the last time
        uint32_t pa[NP / 16][4];
        if constexpr (CH > 1) {  // online across the chunks, unnormalised
          float a0, a1;
          ss_chunk_weights<NP>(sacc, pa, N - c * NP, c == 0, t4, scale_log2e,
                               rm0, rm1, rl0, rl1, a0, a1);
          if (c > 0) {  // the chunk before's sums, complete
            ss_rescale(oacc, a0, a1);
            ss_rescale(yacc, a0, a1);
          }
        } else {
          float inv0, inv1;
          ss_frame_softmax<NP, false>(sacc, pa, N, t4, scale_log2e, inv0,
                                      inv1);
        }
        // both products MN-major: a k-step is 16 keys = 2048 bytes; a
        // frame's first chunk starts its sums, a later one adds to them
        const int add = CH > 1 && c > 0;
        named_barrier(3 + wg, 256);  // this warpgroup's turn: the products
        wgmma_fence();
        {
          const uint64_t dv = wgmma_desc_sw128(slot + KV_TILE, 16, 1024);
          const uint64_t dy = wgmma_desc_sw128(slot + 2 * KV_TILE, 16, 1024);
#pragma unroll
          for (int kk = 0; kk < NP / 16; ++kk)
            wgmma_rs_n64_tb(yacc, pa[kk], dy + (uint64_t)(kk * 128),
                            add | kk);
#pragma unroll
          for (int kk = 0; kk < NP / 16; ++kk)
            wgmma_rs_n64_tb(oacc, pa[kk], dv + (uint64_t)(kk * 128),
                            add | kk);
        }
        wgmma_commit();
        if (!(wg == 1 && last_unit && last))      // the other's turn (none
          named_barrier_arrive(3 + (1 - wg), 256);  // after the last)
        wgmma_wait<0>();
        reg_fence(yacc);
        reg_fence(oacc);
        mbar_arrive(&kv_empty[stage]);  // the slot is free
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if constexpr (CH > 1) {  // the frame's sums, normalised: 1 / l
        const float i0 = 1.f / rl0, i1 = 1.f / rl1;
        ss_rescale(oacc, i0, i1);
        ss_rescale(yacc, i0, i1);
        load_q2();
      }

      // l2_f = q2_h . Y_f * scale, a row's 64 channels on the quad's lanes
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int j = 0; j < SS_HD / 8; ++j) {
        const float2 a = unpack_bf16x2(qa[j]), c = unpack_bf16x2(qb[j]);
        d0 = fmaf(a.x, yacc[4 * j], d0);
        d0 = fmaf(a.y, yacc[4 * j + 1], d0);
        d1 = fmaf(c.x, yacc[4 * j + 2], d1);
        d1 = fmaf(c.y, yacc[4 * j + 3], d1);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        d0 += __shfl_xor_sync(0xffffffffu, d0, o);
        d1 += __shfl_xor_sync(0xffffffffu, d1, o);
      }
      const float e0 = d0 * scale_log2e, e1 = d1 * scale_log2e;
      const float n0 = fmaxf(mx0, e0), n1 = fmaxf(mx1, e1);
      const float al0 = ss_exp2(mx0 - n0), al1 = ss_exp2(mx1 - n1);
      const float w0 = ss_exp2(e0 - n0), w1 = ss_exp2(e1 - n1);
      sum0 = fmaf(sum0, al0, w0);
      sum1 = fmaf(sum1, al1, w1);
      mx0 = n0;
      mx1 = n1;

      if constexpr (V5) {  // mixed from the float32 O_f
#pragma unroll
        for (int e = 0; e < 32; ++e)
          acc[e] = (e & 2) ? fmaf(acc[e], al1, w1 * oacc[e])
                           : fmaf(acc[e], al0, w0 * oacc[e]);
      } else {  // xs_f = bf16(O_f) leaves by TMA; mixed from those values
        unsigned char* ob = my_out + oslot * SS_OUT_BYTES;
        if (storer) tma_store_wait_read<OS - 1>();
        named_barrier(1 + wg, 128);  // the staging tile is free again
#pragma unroll
        for (int j = 0; j < SS_HD / 8; ++j) {
          const uint32_t x0 = pack_bf16x2(oacc[4 * j], oacc[4 * j + 1]);
          const uint32_t x1 = pack_bf16x2(oacc[4 * j + 2], oacc[4 * j + 3]);
          *reinterpret_cast<uint32_t*>(ob + r0 * SS_ROW_BYTES +
                                       ((j ^ (r0 & 7)) << 4) + 4 * t4) = x0;
          *reinterpret_cast<uint32_t*>(ob + r1 * SS_ROW_BYTES +
                                       ((j ^ (r1 & 7)) << 4) + 4 * t4) = x1;
          const float2 a = unpack_bf16x2(x0), c = unpack_bf16x2(x1);
          acc[4 * j] = fmaf(acc[4 * j], al0, w0 * a.x);
          acc[4 * j + 1] = fmaf(acc[4 * j + 1], al0, w0 * a.y);
          acc[4 * j + 2] = fmaf(acc[4 * j + 2], al1, w1 * c.x);
          acc[4 * j + 3] = fmaf(acc[4 * j + 3], al1, w1 * c.y);
        }
        fence_async_smem();
        named_barrier(1 + wg, 128);
        if (storer) {
          if (row0 < S) tma_store_4d(&xs_map, ob, c0, f, row0, b);
          tma_store_commit();
        }
        oslot = oslot + 1 == OS ? 0 : oslot + 1;
      }
    }
    // out = acc / sum, the unit's rows of the head
    const float i0 = 1.f / sum0, i1 = 1.f / sum1;
    bf16* o0 = out + ((size_t)b * S + s_0) * C + c0 + 2 * t4;
    bf16* o1 = o0 + (size_t)8 * C;
#pragma unroll
    for (int j = 0; j < SS_HD / 8; ++j) {
      if (s_0 < S)
        *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
            pack_bf16x2(acc[4 * j] * i0, acc[4 * j + 1] * i0);
      if (s_1 < S)
        *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
            pack_bf16x2(acc[4 * j + 2] * i1, acc[4 * j + 3] * i1);
    }
  }
  if (storer) tma_store_wait_all();
}

template <int NP, bool V5, int CH>
cudaError_t launch_k2v_pass(const bf16* q, const bf16* kf, const bf16* vf,
                            const bf16* k2v, const bf16* q2, bf16* xs,
                            bf16* out, int B, int heads, int S, int F, int N,
                            float scale, cudaStream_t st) {
  CUtensorMap qm, kvm[3], xm;
  const bf16* kv[3] = {kf, vf, k2v};
  cudaError_t e = ss_input_maps<NP>(q, &qm, 3, kv, kvm, B, heads, S, F, N);
  if (e != cudaSuccess) return e;
  if (V5) xm = qm;  // not read
  else e = ss_frames_map(&xm, xs, B, heads, S, F);
  if (e != cudaSuccess) return e;
  constexpr int smem = k2v_pass_smem_bytes(NP);
  static const cudaError_t attr = cudaFuncSetAttribute(
      k2v_pass_kernel<NP, V5, CH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  e = ss_sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int units = B * heads * ((S + SS_ROWS - 1) / SS_ROWS);
  const int grid = units < sms ? units : sms;
  k2v_pass_kernel<NP, V5, CH><<<grid, SS_THREADS, smem, st>>>(
      qm, kvm[0], kvm[1], kvm[2], xm, q2, out, B * heads, heads, S, F, N,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// launches 2, 3 and 4 at the instantiated key width for N (N <= SS_MAX_NP),
// or past it in the chunked form, two chunks of ss_chunk_keys(N) keys
template <bool V5>
cudaError_t launch_k2v_keys(const bf16* q, const bf16* kf, const bf16* vf,
                            const bf16* k2v, bf16* x_diag, const bf16* wq2,
                            const bf16* bq2, bf16* q2, bf16* xs, bf16* out,
                            int B, int heads, int S, int F, int N,
                            float scale, int* launched, cudaStream_t st) {
  auto run = [&](auto np, auto ch) -> cudaError_t {
    constexpr int NP = decltype(np)::value, CH = decltype(ch)::value;
    cudaError_t e = launch_own_frame<NP, CH>(q, kf, vf, x_diag, B, heads, S,
                                             F, N, scale, st);
    if (e != cudaSuccess) return e;
    ++*launched;
    // row m of x_diag itself (F = S = N = 1 in the GEMM's gather)
    e = launch_gemm(x_diag, wq2, bq2, q2, B * S, 1, 1, 1, heads * HD, st);
    if (e != cudaSuccess) return e;
    ++*launched;
    e = launch_k2v_pass<NP, V5, CH>(q, kf, vf, k2v, q2, xs, out, B, heads, S,
                                    F, N, scale, st);
    if (e == cudaSuccess) ++*launched;
    return e;
  };
  using one = std::integral_constant<int, 1>;
  using chunks = std::integral_constant<int, SS_CHUNKS>;
  if (N > SS_MAX_NP)
    return ss_chunk_keys(N) == 224
               ? run(std::integral_constant<int, 224>(), chunks())
               : run(std::integral_constant<int, 256>(), chunks());
  switch (ss_padded_keys(N)) {
    case 64: return run(std::integral_constant<int, 64>(), one());
    case 128: return run(std::integral_constant<int, 128>(), one());
    case 208: return run(std::integral_constant<int, 208>(), one());
    default: return run(std::integral_constant<int, 256>(), one());
  }
}

// The four launches of one v5 (V5) or v6 call; ``agg`` is x_diag [B, S, C]
// for v5 and xs [B, S, F, C] for v6 (whose x_diag waits in out). Counts
// each launch made into *launched and returns the first cudaError_t met.
template <bool V5>
int traj_core_k2v(const void* q, const void* kf, const void* vf,
                  const void* wq2, const void* bq2, const void* wk2,
                  void* k2v, void* agg, void* q2, void* out, int* launched,
                  int B, int S, int F, int N, int C, int heads, float scale,
                  void* stream) {
  *launched = 0;
  if (B <= 0 || N <= 0 || N > SS_MAX_KEYS || F <= 0 || F > MAX_F ||
      S != F * N || heads <= 0 || heads > MAX_HEADS || C != heads * HD ||
      C % GN != 0 || !aligned16(q) || !aligned16(kf) || !aligned16(vf) ||
      !aligned16(k2v) || !aligned16(agg) || !aligned16(q2) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* vf_ = static_cast<const bf16*>(vf);
  bf16* k2v_ = static_cast<bf16*>(k2v);
  bf16* out_ = static_cast<bf16*>(out);
  cudaError_t err = launch_gemm(vf_, static_cast<const bf16*>(wk2), nullptr,
                                k2v_, B * F * N, 1, 1, 1, C, st);
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  err = launch_k2v_keys<V5>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kf), vf_, k2v_,
      V5 ? static_cast<bf16*>(agg) : out_, static_cast<const bf16*>(wq2),
      static_cast<const bf16*>(bq2), static_cast<bf16*>(q2),
      V5 ? nullptr : static_cast<bf16*>(agg), out_, B, heads, S, F, N, scale,
      launched, st);
  return (int)err;
}

}  // namespace
