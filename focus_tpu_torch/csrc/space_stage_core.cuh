// The trajectory-attention stage 1 on wgmma and TMA, shared by the space
// stage (trajectory_attention.cu, kernel 8) and the fused trajectory core's
// forward (trajectory_block.cu, kernel 1, and in the rounding mode V3 below
// kernels 3 and 4; in the own-frame mode below, kernels 5 and 6's x_diag):
//
//   out[b, s, f, h] = softmax(q[b, s, h] . kf[b, f, :, h]^T * scale)
//                     . vf[b, f, :, h]
//
// over frame f's N keys for every head h of C = heads * 64 channels, a true
// max-subtracted softmax whose weights are rounded to bf16 before the
// product, with float32 sums on the tensor cores. The layouts are the fused
// core's: q [B, S, C], kf and vf [B, F, N, C], out [B, S, F, C], heads side
// by side in the channels. The space stage's [BH, S, d] / [BH, F, N, d] /
// [BH, S, F, d] are the same layouts with B = BH and one head of C = 64, so
// its tensor maps, coordinates and results are what they were before the
// kernel moved here. ops/_build.py hashes this header with every source.
//
// Bound on this card at B x heads = 96, S = 1568, F = 8, N = 196: 60.4
// GFLOP (0.0611 ms at 989 TFLOP/s) against 211.9 MB (q, k, v 19.3 MB each,
// the output 154.1 MB: 0.0633 ms at 3.35 TB/s), so it is bound by bytes,
// three quarters of them the output's. A second floor is the softmax's
// exponentials: B heads S S / F = 236 M ex2 at N = 196, ~0.064 ms on the
// SFUs (16 a clock and SM at ~1.75 GHz), as much as either bound; the
// design spends one ex2 per logit (scale * log2(e) folded into one FMA
// before it) and lets one warpgroup's exponentials overlap the other's
// products.
//
// Design (one launch a call; a persistent grid of one block per SM, each
// walking (b, head, 128-query tile) units head-major, so that the blocks in
// flight share a few heads' K/V in L2 and the producer loads the next
// unit's tiles under the current one's work):
//   - a producer warpgroup (one thread issues; setmaxnreg leaves it 40
//     registers and gives the consumers 232) keeps a ring of `stages` frame
//     slots in flight, each K_f and V_f [NP, 64] bf16 of one head copied by
//     TMA in the 128-byte swizzled layout (keys past N read as zero; the
//     head is the 64-channel box at channel 64 h of the [.., C] rows), and
//     a ring of two Q tiles [128, 64]; every slot has a full and an empty
//     mbarrier;
//   - two consumer warpgroups own 64 query rows each. Per frame: the logits
//     S = Q . K_f^T by wgmma m64nNPk16 from shared memory (4 k-steps), the
//     softmax on the accumulator registers (keys >= N at -inf, the row max
//     and sum over the quad of lanes that holds a row), P normalised and
//     rounded to bf16 in registers, which become the A operand of the
//     second wgmma, m64n64k16 against V_f read MN-major (transposed) from
//     the slot: P never goes through shared memory;
//   - the two warpgroups take turns at the tensor cores (ping-pong on two
//     named barriers): a turn issues PV of the frame before and QK of this
//     frame back to back, then hands over, so that one warpgroup's
//     products run while the other's softmax does; a warpgroup writes the
//     frame before's output as soon as its PV is done, while its QK runs;
//   - the output tile [64, 64] of a frame and head is written into one of
//     two swizzled staging tiles of the warpgroup and leaves by a TMA store
//     (rows past S are not written), which runs while the next frame's
//     wgmmas do; each staging tile is reused only after its previous store
//     has read it;
//   - shared memory at NP = 208 (N = 196, 200): three K/V slots of 52 KB,
//     the Q ring 32 KB and the staging tiles 32 KB, 227 KB, one block an
//     SM; a consumer thread holds the logits of one frame (104 registers),
//     P of the frame before (52) and the outputs (32) at once.
//
// Rounding mode V3 (the trajectory core's forward versions 3 and 7, whose
// TPU kernels round the weights before they normalise them): the consumer
// packs the unnormalised p = exp(logit * scale - max) to bf16 as the A
// operand of P . V, keeps 1 / s of the unrounded row sums s, and scales the
// frame's float32 P . V sums by it before the bf16 store: xs = round((
// round(p) . V) * (1 / s)). The plain version divides, o / s; o * (1 / s)
// is within one float32 step of it before the bf16 rounding, and the card
// holds xs against the plain version's within the kernels' gate. 1 / s of
// the frame before lives across the turn as P does (two registers): it is
// formed after this frame's softmax and read when this frame's output
// leaves, one turn later. With V3 false the arithmetic is the space
// stage's, bit for bit.
//
// Chunked form (CH = 2, at SS_MAX_NP < N <= SS_MAX_KEYS: the 336 crop's N
// = 441, 445; kernel 1's stage 1 and so kernels 3 and 4's, kernel 8, and in
// the own-frame mode kernels 5 and 6's x_diag). A frame's logits at NP =
// 448 would take 224 registers a consumer thread, and one frame's K and V
// 115 KB, so a frame's keys go in two chunks of 224 (of 256 past N = 448)
// and the ring's unit is a (frame, chunk) slot of 57 KB: three of them
// beside the Q ring and one staging tile a warpgroup (a frame leaves every
// second turn). A turn issues P . V of the chunk before and the logits of
// this chunk; the softmax runs online across a frame's chunks
// (ss_chunk_softmax: chunk 0 starts the row max m and sum l, chunk 1 raises
// m and scales l and the P . V sums by exp(m_old - m_new) after chunk 0's
// P . V has completed and before its own accumulates), the weights are
// packed unnormalised relative to the running max, and the frame's float32
// sums are scaled by 1 / l before the bf16 store: the rounding of the mode
// V3, which moves the rounding point of kernels 1, 5, 6 and 8 at N > 256
// only (kernels 3 and 4 round there already). Bound at B x heads = 48, S =
// 3528, F = 8, N = 441 (B = 4, the HR batch): 152.9 GFLOP (0.155 ms at 989
// TFLOP/s) against 238 MB (the output 173 MB; 0.071 ms), so operations.
//
// Own-frame mode (DIAG; trajectory_k2v.cuh's own_frame_kernel, the forward
// versions 5 and 6): a unit visits only the frames its 128 rows lie in
// (one or two at N = 196) and stores each row's own frame alone, x_diag
// [B, S, C], by plain stores from the registers. The arithmetic is the
// space stage's, so x_diag is the own-frame rows of what the space stage
// writes, bit for bit; the softmax lives in ss_frame_softmax, which
// trajectory_k2v.cuh's pass calls too.

#pragma once

#include "hopper_async.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int SS_HD = 64;                        // head dim: a row is 128 B
constexpr int SS_ROW_BYTES = SS_HD * 2;
constexpr int SS_WG = 2;                         // consumer warpgroups
constexpr int SS_ROWS = 64 * SS_WG;              // query rows a unit
constexpr int SS_THREADS = 128 * (SS_WG + 1);   // and the producer's
// registers a thread after setmaxnreg: the producer warpgroup gives up what
// the consumers take (3 x 168 = 40 + 2 x 232 a lane of each SM sub-partition)
constexpr int SS_PRODUCER_REGS = 40;
constexpr int SS_CONSUMER_REGS = 232;
constexpr int SS_MAX_NP = 256;
// the chunked form (N > SS_MAX_NP; every stage-1 kernel and the k2v pass):
// a frame's keys in SS_CHUNKS chunks of at most SS_MAX_NP, up to
// SS_MAX_KEYS keys a frame
constexpr int SS_MAX_KEYS = 512;
constexpr int SS_CHUNKS = 2;
constexpr int SS_MAX_STAGES = 4;
constexpr int SS_Q_SLOTS = 2;
constexpr int SS_OUT_SLOTS = 2;                  // staging tiles a warpgroup
constexpr int SS_Q_BYTES = SS_ROWS * SS_ROW_BYTES;
constexpr int SS_WG_ROWS_BYTES = 64 * SS_ROW_BYTES;  // 64 rows of a tile
constexpr int SS_OUT_BYTES = SS_WG_ROWS_BYTES;
constexpr int SS_ALIGN = 1024;                   // the 128-byte swizzle atom
constexpr int SS_BAR_BYTES = 1024;
constexpr int SS_SMEM_LIMIT = 232448;

// keys a frame is padded to: the instantiated wgmma widths
__host__ __device__ constexpr int ss_padded_keys(int n) {
  return n <= 64 ? 64 : (n <= 128 ? 128 : (n <= 208 ? 208 : 256));
}

// keys a chunk in the chunked form: two chunks of 224 up to N = 448
// (441 and 445 at the 336 crop), else of 256
__host__ __device__ constexpr int ss_chunk_keys(int n) {
  return n <= 448 ? 224 : 256;
}

__host__ __device__ constexpr int ss_stage_bytes(int np) {
  return 2 * np * SS_ROW_BYTES;  // K_f and V_f (of a chunk)
}

// output staging tiles a warpgroup: two, or one in the chunked form, where
// a frame leaves every second turn (the bytes go to a third K/V slot)
__host__ __device__ constexpr int ss_out_slots(int ch) {
  return ch > 1 ? 1 : SS_OUT_SLOTS;
}

__host__ __device__ constexpr int ss_fixed_bytes(int ch = 1) {
  return SS_ALIGN + SS_Q_SLOTS * SS_Q_BYTES +
         SS_WG * ss_out_slots(ch) * SS_OUT_BYTES + SS_BAR_BYTES;
}

__host__ __device__ constexpr int ss_stages(int np, int ch = 1) {
  return (SS_SMEM_LIMIT - ss_fixed_bytes(ch)) / ss_stage_bytes(np) <
                 SS_MAX_STAGES
             ? (SS_SMEM_LIMIT - ss_fixed_bytes(ch)) / ss_stage_bytes(np)
             : SS_MAX_STAGES;
}

__host__ __device__ constexpr int ss_smem_bytes(int np, int ch = 1) {
  return ss_fixed_bytes(ch) + ss_stages(np, ch) * ss_stage_bytes(np);
}

static_assert(ss_stages(SS_MAX_NP) >= 2, "two frame slots at N = 256");
static_assert(ss_stages(224, SS_CHUNKS) >= 3 &&
                  ss_stages(256, SS_CHUNKS) >= 2,
              "three chunk slots at N <= 448, two at N <= 512");

__device__ __forceinline__ float ss_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The softmax of one frame on the logits' registers (a warpgroup's 64 rows
// by NP keys in the accumulators' layout: element 4j + e is key 8j + 2 t4 +
// (e & 1), the second row for e >= 2): keys >= N at -inf, the row max and
// sum over the quad of lanes that holds a row, one ex2 per logit (scale *
// log2(e) folded into one FMA before it), and the weights packed to bf16 as
// the A fragments of the products that follow (k-step kk: keys 16 kk ..
// 16 kk + 15). Normalised before the rounding, or (V3) unnormalised, the
// caller scaling the products by inv0 / inv1 = 1 / s of its two rows.
template <int NP, bool V3>
__device__ __forceinline__ void ss_frame_softmax(float (&sacc)[NP / 2],
                                                 uint32_t (&pa)[NP / 16][4],
                                                 int N, int t4,
                                                 float scale_log2e,
                                                 float& inv0, float& inv1) {
  // keys below this always exist (N is above the next smaller width)
  constexpr int SAFE_KEYS = NP == 64 ? 0 : (NP == 128 ? 64 : (NP == 208 ? 128 : 208));
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t4 + (e & 1);
      const float v = (8 * j + 8 <= SAFE_KEYS || key < N) ? sacc[4 * j + e]
                                                          : -INFINITY;
      sacc[4 * j + e] = v;
      if (e < 2) m0 = fmaxf(m0, v);
      else m1 = fmaxf(m1, v);
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  const float mb0 = m0 * scale_log2e, mb1 = m1 * scale_log2e;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // ex2(-inf) = 0 for the padding
      const float p = ss_exp2(
          fmaf(sacc[4 * j + e], scale_log2e, e < 2 ? -mb0 : -mb1));
      sacc[4 * j + e] = p;
      if (e < 2) l0 += p;
      else l1 += p;
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  inv0 = 1.f / l0;
  inv1 = 1.f / l1;
  if constexpr (V3) {  // rounded unnormalised; 1 / s waits for P . V
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      pa[kk][0] = pack_bf16x2(sacc[8 * kk], sacc[8 * kk + 1]);
      pa[kk][1] = pack_bf16x2(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pa[kk][2] = pack_bf16x2(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pa[kk][3] = pack_bf16x2(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      pa[kk][0] = pack_bf16x2(sacc[8 * kk] * inv0, sacc[8 * kk + 1] * inv0);
      pa[kk][1] = pack_bf16x2(sacc[8 * kk + 2] * inv1, sacc[8 * kk + 3] * inv1);
      pa[kk][2] = pack_bf16x2(sacc[8 * kk + 4] * inv0, sacc[8 * kk + 5] * inv0);
      pa[kk][3] = pack_bf16x2(sacc[8 * kk + 6] * inv1, sacc[8 * kk + 7] * inv1);
    }
  }
}

// The weights of one chunk of a frame's keys in the chunked form (keys
// 0 .. nvalid - 1 of the chunk exist; the accumulators' layout as above),
// the softmax online across the frame's chunks: the first chunk (first)
// starts the rows' running max m and sum l; a later one raises m where its
// logits do and scales l by a = exp(m_old - m_new), which it also returns
// (a0, a1 of the two rows), for the caller to scale the frame's sums so
// far by. The weights are packed unnormalised, relative to the running
// max, as in the rounding mode V3; the caller scales the frame's sums by
// 1 / l before the bf16 store.
template <int NP>
__device__ __forceinline__ void ss_chunk_weights(
    float (&sacc)[NP / 2], uint32_t (&pa)[NP / 16][4], int nvalid,
    bool first, int t4, float scale_log2e, float& m0, float& m1, float& l0,
    float& l1, float& a0, float& a1) {
  float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t4 + (e & 1);
      const float v = key < nvalid ? sacc[4 * j + e] : -INFINITY;
      sacc[4 * j + e] = v;
      if (e < 2) c0 = fmaxf(c0, v);
      else c1 = fmaxf(c1, v);
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, o));
    c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, o));
  }
  const float n0 = first ? c0 : fmaxf(m0, c0);
  const float n1 = first ? c1 : fmaxf(m1, c1);
  // unfused products, so that m_old = m_new gives exp(0) = 1 exactly
  const float mb0 = __fmul_rn(n0, scale_log2e);
  const float mb1 = __fmul_rn(n1, scale_log2e);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // ex2(-inf) = 0 for the padding
      const float p = ss_exp2(
          fmaf(sacc[4 * j + e], scale_log2e, e < 2 ? -mb0 : -mb1));
      sacc[4 * j + e] = p;
      if (e < 2) s0 += p;
      else s1 += p;
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if (first) {
    l0 = s0;
    l1 = s1;
    a0 = a1 = 1.f;
  } else {  // exp(m_old - m_new): 1 where the chunk left the max as it was
    a0 = ss_exp2(__fmul_rn(m0, scale_log2e) - mb0);
    a1 = ss_exp2(__fmul_rn(m1, scale_log2e) - mb1);
    l0 = fmaf(l0, a0, s0);
    l1 = fmaf(l1, a1, s1);
  }
  m0 = n0;
  m1 = n1;
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(sacc[8 * kk], sacc[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(sacc[8 * kk + 2], sacc[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(sacc[8 * kk + 4], sacc[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(sacc[8 * kk + 6], sacc[8 * kk + 7]);
  }
}

// the frame's sums so far (oacc, complete: the chunk before's P . V ran in
// this turn) scaled by a later chunk's exp(m_old - m_new) of their row
__device__ __forceinline__ void ss_rescale(float (&oacc)[32], float a0,
                                           float a1) {
#pragma unroll
  for (int e = 0; e < 32; ++e) oacc[e] *= (e & 2) ? a1 : a0;
}

// The softmax of one chunk (ss_chunk_weights) with the frame's P . V sums
// so far rescaled, as the stage-1 kernel body runs it; the k2v pass
// (trajectory_k2v.cuh) rescales its second sums, P . k2v, by the same a
template <int NP>
__device__ __forceinline__ void ss_chunk_softmax(
    float (&sacc)[NP / 2], uint32_t (&pa)[NP / 16][4], float (&oacc)[32],
    int nvalid, bool first, int t4, float scale_log2e, float& m0, float& m1,
    float& l0, float& l1) {
  float a0, a1;
  ss_chunk_weights<NP>(sacc, pa, nvalid, first, t4, scale_log2e, m0, m1, l0,
                       l1, a0, a1);
  if (!first) ss_rescale(oacc, a0, a1);
}

// The frames a unit of 128 query rows from s0 visits, [lo, hi): all F, or
// (DIAG) the frames its rows lie in
template <bool DIAG>
__device__ __forceinline__ void ss_unit_frames(int s0, int S, int F, int N,
                                               int& lo, int& hi) {
  lo = DIAG ? s0 / N : 0;
  hi = DIAG ? (min(s0 + SS_ROWS, S) - 1) / N + 1 : F;
}

// The kernel's body. With DIAG (the own-frame mode of the trajectory
// core's forward versions 5 and 6) a unit visits only the frames its rows
// lie in (one or two at N = 196 and 441) and each row's own frame alone
// leaves, as diag[b, s, head] ([B, S, C]) by plain stores from the
// registers; o_map is not used then, and diag is not used otherwise. With
// CH > 1 (the chunked form, N > SS_MAX_NP) NP is the width of a chunk: a
// slot of the ring holds one chunk of a frame's keys (keys c NP .. c NP +
// NP - 1 of chunk c; keys past N read as zero), a turn issues P . V of the
// chunk before and the logits of this chunk, the softmax runs online
// across a frame's chunks (ss_chunk_softmax), and a frame leaves after its
// last chunk's P . V, its sums scaled by 1 / l (in both modes).
template <int NP, bool V3, bool DIAG, int CH = 1>
__device__ __forceinline__ void space_stage_body(
    const CUtensorMap* q_map, const CUtensorMap* k_map,
    const CUtensorMap* v_map, const CUtensorMap* o_map, bf16* diag, int BH,
    int heads, int S, int F, int N, float scale_log2e) {
  static_assert(!(V3 && DIAG), "the own-frame mode rounds as the space stage");
  static_assert(CH == 1 || !V3, "the chunked form rounds as V3 already");
  constexpr int KV_TILE = NP * SS_ROW_BYTES;
  constexpr int STAGES = ss_stages(NP, CH);
  constexpr int OUT_SLOTS = ss_out_slots(CH);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((SS_ALIGN - (cvta_smem(smem_raw) & (SS_ALIGN - 1))) &
                  (SS_ALIGN - 1));
  unsigned char* kv = smem;                    // slot s: K, then V
  unsigned char* qbuf = kv + STAGES * 2 * KV_TILE;
  unsigned char* obuf = qbuf + SS_Q_SLOTS * SS_Q_BYTES;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(obuf + SS_WG * OUT_SLOTS * SS_OUT_BYTES);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + SS_MAX_STAGES;
  uint64_t* q_full = bars + 2 * SS_MAX_STAGES;
  uint64_t* q_empty = q_full + SS_Q_SLOTS;

  const int tiles = (S + SS_ROWS - 1) / SS_ROWS;
  const int units = BH * tiles;  // BH = B x heads: (b, head) pairs
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 128 * SS_WG);
    }
    for (int s = 0; s < SS_Q_SLOTS; ++s) {
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
        const int qs = u & 1;
        int f_lo, f_hi;
        ss_unit_frames<DIAG>(s0, S, F, N, f_lo, f_hi);
        mbar_wait(&q_empty[qs], ((u >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qs], SS_Q_BYTES);
        tma_load_3d(qbuf + qs * SS_Q_BYTES, q_map, &q_full[qs], c0, s0, b);
        for (int f = f_lo; f < f_hi; ++f)
          for (int c = 0; c < CH; ++c) {  // chunk c: keys from c NP
            mbar_wait(&kv_empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&kv_full[stage], 2 * KV_TILE);
            unsigned char* kd = kv + stage * 2 * KV_TILE;
            tma_load_3d(kd, k_map, &kv_full[stage], c0, c * NP, b * F + f);
            tma_load_3d(kd + KV_TILE, v_map, &kv_full[stage], c0, c * NP,
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
  const bool storer = wtid == 0;
  unsigned char* my_out = obuf + wg * OUT_SLOTS * SS_OUT_BYTES;
  // The two warpgroups take turns at the tensor cores (named barriers 3 and
  // 4): a turn issues PV of the frame before and QK of this frame, so one
  // warpgroup's products run while the other's softmax does.
  if (wg == 1) named_barrier_arrive(3, 256);  // warpgroup 0 goes first
  int stage = 0, oslot = 0, u = 0;
  uint32_t phase = 0;
  uint32_t pa[NP / 16][4];  // P of the frame before, bf16 A fragments
  float oacc[32];
  float pinv0 = 0.f, pinv1 = 0.f;  // V3, CH > 1: its rows' 1 / s (or l)
  float rm0 = 0.f, rm1 = 0.f, rl0 = 0.f, rl1 = 0.f;  // CH > 1: running m, l
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x, ++u) {
    const int bh = unit / tiles;
    const int b = bh / heads, c0 = (bh % heads) * SS_HD;
    const int s0 = (unit % tiles) * SS_ROWS;
    const int row0 = s0 + wg * 64;  // this warpgroup's
    const int qs = u & 1;
    const bool last_unit = unit + (int)gridDim.x >= units;
    int f_lo, f_hi;
    ss_unit_frames<DIAG>(s0, S, F, N, f_lo, f_hi);
    const int items = (f_hi - f_lo) * CH;  // (frame, chunk) slots
    mbar_wait(&q_full[qs], (u >> 1) & 1);
    const uint64_t dq = wgmma_desc_sw128(
        qbuf + qs * SS_Q_BYTES + wg * SS_WG_ROWS_BYTES, 16, 1024);
    int pstage = 0;  // the slot of the item before
    for (int i = 0; i <= items; ++i) {
      // QK of item i (frame f_lo + i / CH, chunk i % CH), PV of item i - 1
      // (frame pf); with CH = 1 an item is a frame
      const int pf = f_lo + (i - 1) / CH;
      const bool qk = i < items, pv = i > 0;
      const bool frame_done = CH == 1 || (i - 1) % CH == CH - 1;
      float sacc[NP / 2];
      named_barrier(3 + wg, 256);  // this warpgroup's turn
      wgmma_fence();
      if (pv) {  // P . V_f-1: V MN-major, a k-step is 16 keys = 2048 bytes
        const uint64_t dv = wgmma_desc_sw128(
            kv + pstage * 2 * KV_TILE + KV_TILE, 16, 1024);
        // a frame's first chunk starts its sums, a later one adds to them
        const int acc = CH > 1 && (i - 1) % CH != 0;
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk)
          wgmma_rs_n64_tb(oacc, pa[kk], dv + (uint64_t)(kk * 128),
                          CH > 1 ? (acc | kk) : kk);
      }
      wgmma_commit();  // group 1: PV (empty at i = 0)
      if (qk) {  // logits: 4 k-steps of 16 channels, 32 bytes along a row
        mbar_wait(&kv_full[stage], phase);
        const uint64_t dk =
            wgmma_desc_sw128(kv + stage * 2 * KV_TILE, 16, 1024);
#pragma unroll
        for (int k = 0; k < SS_HD / 16; ++k)
          wgmma_ss<NP>(sacc, dq + 2 * k, dk + 2 * k, k);
      }
      wgmma_commit();  // group 2: QK (empty at i = items)
      if (!(wg == 1 && i == items && last_unit))  // the other's turn (none
        named_barrier_arrive(3 + (1 - wg), 256);  // after the last)
      wgmma_wait<1>();  // PV done: its output leaves while QK runs
      reg_fence(oacc);

      if (pv) {  // the item before: its slot is free
        mbar_arrive(&kv_empty[pstage]);
      }
      if (pv && frame_done) {  // frame pf is complete: its output leaves
        const int r0 = 16 * warp + g, r1 = r0 + 8;
        if constexpr (DIAG) {  // the rows whose own frame it is
          if constexpr (CH > 1) ss_rescale(oacc, pinv0, pinv1);  // 1 / l
          const int C = heads * SS_HD;
          const int s_0 = row0 + r0, s_1 = row0 + r1;
          bf16* o0 = diag + ((size_t)b * S + s_0) * C + c0 + 2 * t4;
          bf16* o1 = o0 + (size_t)8 * C;
          const bool w0 = s_0 < S && s_0 / N == pf;
          const bool w1 = s_1 < S && s_1 / N == pf;
#pragma unroll
          for (int j = 0; j < SS_HD / 8; ++j) {
            if (w0)
              *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
                  pack_bf16x2(oacc[4 * j], oacc[4 * j + 1]);
            if (w1)
              *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
                  pack_bf16x2(oacc[4 * j + 2], oacc[4 * j + 3]);
          }
        } else {
          unsigned char* ob = my_out + oslot * SS_OUT_BYTES;
          if (storer) tma_store_wait_read<OUT_SLOTS - 1>();
          named_barrier(1 + wg, 128);  // the staging tile is free again
          if constexpr (V3 || CH > 1) {  // the frame's sums, normalised
#pragma unroll
            for (int e = 0; e < 32; ++e) oacc[e] *= (e & 2) ? pinv1 : pinv0;
          }
#pragma unroll
          for (int j = 0; j < SS_HD / 8; ++j) {
            *reinterpret_cast<uint32_t*>(ob + r0 * SS_ROW_BYTES +
                                         ((j ^ (r0 & 7)) << 4) + 4 * t4) =
                pack_bf16x2(oacc[4 * j], oacc[4 * j + 1]);
            *reinterpret_cast<uint32_t*>(ob + r1 * SS_ROW_BYTES +
                                         ((j ^ (r1 & 7)) << 4) + 4 * t4) =
                pack_bf16x2(oacc[4 * j + 2], oacc[4 * j + 3]);
          }
          fence_async_smem();
          named_barrier(1 + wg, 128);
          if (storer) {
            if (row0 < S) tma_store_4d(o_map, ob, c0, pf, row0, b);
            tma_store_commit();
          }
          if constexpr (OUT_SLOTS > 1) oslot ^= 1;
        }
      }
      wgmma_wait<0>();
      reg_fence(sacc);
      if (!qk) continue;
      if (i == items - 1) mbar_arrive(&q_empty[qs]);  // Q read for the last time
      pstage = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      if constexpr (CH > 1) {
        const int c = i % CH;
        ss_chunk_softmax<NP>(sacc, pa, oacc, N - c * NP, c == 0, t4,
                             scale_log2e, rm0, rm1, rl0, rl1);
        if (c == CH - 1) {  // the frame's 1 / l, read when it leaves
          pinv0 = 1.f / rl0;
          pinv1 = 1.f / rl1;
        }
      } else {
        float inv0, inv1;
        ss_frame_softmax<NP, V3>(sacc, pa, N, t4, scale_log2e, inv0, inv1);
        if constexpr (V3) {
          pinv0 = inv0;
          pinv1 = inv1;
        }
      }
    }
  }
  if (storer) tma_store_wait_all();
}

template <int NP, bool V3>
__global__ void __launch_bounds__(SS_THREADS, 1) space_stage_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap o_map, int BH, int heads, int S,
    int F, int N, float scale_log2e) {
  space_stage_body<NP, V3, false>(&q_map, &k_map, &v_map, &o_map, nullptr,
                                  BH, heads, S, F, N, scale_log2e);
}

// the chunked form (N > SS_MAX_NP), NP keys a chunk
template <int NP>
__global__ void __launch_bounds__(SS_THREADS, 1) space_stage_chunked_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap o_map, int BH, int heads, int S,
    int F, int N, float scale_log2e) {
  space_stage_body<NP, false, false, SS_CHUNKS>(
      &q_map, &k_map, &v_map, &o_map, nullptr, BH, heads, S, F, N,
      scale_log2e);
}

// the kernel of a width and form: the chunked one where CH > 1
template <int NP, bool V3, int CH>
auto ss_kernel() {
  if constexpr (CH > 1) return &space_stage_chunked_kernel<NP>;
  else return &space_stage_kernel<NP, V3>;
}

// the card's SM count, asked for once
inline cudaError_t ss_sm_count(int* sms) {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms = count;
  return cudaSuccess;
}

// tensor maps of q [B, S, C] (a unit's 128 rows of one head; rows past S
// read as zeros) and of the nkv [B F, N, C] tensors kv[i] (a frame's NP
// keys of one head, or in the chunked form a chunk's NP keys from its
// first key; keys past N read as zeros), C = heads * 64
template <int NP>
cudaError_t ss_input_maps(const bf16* q, CUtensorMap* qm, int nkv,
                          const bf16* const* kv, CUtensorMap* kvm, int B,
                          int heads, int S, int F, int N) {
  const cuuint64_t C = (cuuint64_t)heads * SS_HD;
  const cuuint64_t row = C * 2;  // bytes of a [.., C] row
  {
    const cuuint64_t dims[3] = {C, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[2] = {row, row * S};
    const cuuint32_t box[3] = {SS_HD, SS_ROWS, 1};
    const cudaError_t e = make_bf16_map(qm, q, 3, dims, strides, box);
    if (e != cudaSuccess) return e;
  }
  const cuuint64_t dims[3] = {C, (cuuint64_t)N, (cuuint64_t)B * F};
  const cuuint64_t strides[2] = {row, row * N};
  const cuuint32_t box[3] = {SS_HD, NP, 1};
  for (int i = 0; i < nkv; ++i) {
    const cudaError_t e = make_bf16_map(&kvm[i], kv[i], 3, dims, strides, box);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// a tensor map of out [B, S, F, C]: 64 rows of one frame and head (rows
// past S are not written)
inline cudaError_t ss_frames_map(CUtensorMap* om, bf16* out, int B,
                                 int heads, int S, int F) {
  const cuuint64_t C = (cuuint64_t)heads * SS_HD;
  const cuuint64_t row = C * 2;
  const cuuint64_t dims[4] = {C, (cuuint64_t)F, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, row * F, row * F * S};
  const cuuint32_t box[4] = {SS_HD, 1, 64, 1};
  return make_bf16_map(om, out, 4, dims, strides, box);
}

// q [B, S, C], kf / vf [B, F, N, C], out [B, S, F, C] with C = heads * 64;
// CH > 1: the chunked form, NP keys a chunk
template <int NP, bool V3, int CH = 1>
cudaError_t launch_space_stage(const bf16* q, const bf16* kf, const bf16* vf,
                               bf16* out, int B, int heads, int S, int F,
                               int N, float scale, cudaStream_t st) {
  CUtensorMap qm, kvm[2], om;
  const bf16* kv[2] = {kf, vf};
  cudaError_t e = ss_input_maps<NP>(q, &qm, 2, kv, kvm, B, heads, S, F, N);
  if (e != cudaSuccess) return e;
  e = ss_frames_map(&om, out, B, heads, S, F);
  if (e != cudaSuccess) return e;
  constexpr int smem = ss_smem_bytes(NP, CH);
  const auto kernel = ss_kernel<NP, V3, CH>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  e = ss_sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int units = B * heads * ((S + SS_ROWS - 1) / SS_ROWS);
  const int grid = units < sms ? units : sms;
  kernel<<<grid, SS_THREADS, smem, st>>>(qm, kvm[0], kvm[1], om, B * heads,
                                         heads, S, F, N,
                                         scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// the instantiation for N keys a frame (N <= SS_MAX_NP), in the space
// stage's rounding or (V3) the forward versions 3 and 7's
template <bool V3 = false>
cudaError_t launch_space_stage_keys(const bf16* q, const bf16* kf,
                                    const bf16* vf, bf16* out, int B,
                                    int heads, int S, int F, int N,
                                    float scale, cudaStream_t st) {
  switch (ss_padded_keys(N)) {
    case 64:
      return launch_space_stage<64, V3>(q, kf, vf, out, B, heads, S, F, N,
                                        scale, st);
    case 128:
      return launch_space_stage<128, V3>(q, kf, vf, out, B, heads, S, F, N,
                                         scale, st);
    case 208:
      return launch_space_stage<208, V3>(q, kf, vf, out, B, heads, S, F, N,
                                         scale, st);
    default:
      return launch_space_stage<256, V3>(q, kf, vf, out, B, heads, S, F, N,
                                         scale, st);
  }
}

// the chunked form for SS_MAX_NP < N <= SS_MAX_KEYS (the 336 crop: N =
// 441, 445), two chunks of ss_chunk_keys(N) keys: kernel 1's stage 1 (and
// so kernels 3 and 4's) at heads of 64 channels side by side, kernel 8 at
// heads = 1, B = BH
inline cudaError_t launch_space_stage_chunked(const bf16* q, const bf16* kf,
                                              const bf16* vf, bf16* out,
                                              int B, int heads, int S, int F,
                                              int N, float scale,
                                              cudaStream_t st) {
  if (ss_chunk_keys(N) == 224)
    return launch_space_stage<224, false, SS_CHUNKS>(q, kf, vf, out, B, heads,
                                                     S, F, N, scale, st);
  return launch_space_stage<256, false, SS_CHUNKS>(q, kf, vf, out, B, heads,
                                                   S, F, N, scale, st);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
