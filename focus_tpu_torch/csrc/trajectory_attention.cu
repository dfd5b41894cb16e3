// Trajectory-attention stage 1 alone (the space stage) for Hopper (sm_90a).
//
// Replaces the TPU kernel focus_tpu/ops/pallas/trajectory_attention.py
// (_space_stage_kernel, called through _space_stage_fwd_pallas /
// space_stage_fused), which the learned-v trajectory attention runs:
//
//   out[bh, s, f] = softmax(q[bh, s] . kf[bh, f]^T * scale) . vf[bh, f]
//
// over frame f's N keys, a true max-subtracted softmax whose weights are
// rounded to bf16 before the product (the TPU kernel's p.astype(v.dtype)),
// with float32 sums on the tensor cores. The output is written directly in
// [BH, S, F, d]: the TPU kernel writes [BH, F, S, d] and transposes, a copy
// of the whole output.
//
// Bound on this card at BH = 96, S = 1568, F = 8, N = 196, d = 64: 60.4
// GFLOP (0.0611 ms at 989 TFLOP/s) against 211.9 MB (q, k, v 19.3 MB each,
// the output 154.1 MB: 0.0633 ms at 3.35 TB/s), so it is bound by bytes,
// three quarters of them the output's. A second floor is the softmax's
// exponentials: BH * S * S = 236 M ex2 at N = 196, ~0.064 ms on the SFUs
// (16 a clock and SM at ~1.75 GHz), as much as either bound; the design
// spends one ex2 per logit (scale * log2(e) folded into one FMA before it)
// and lets one warpgroup's exponentials overlap the other's products.
//
// Design: the kernel lives in space_stage_core.cuh, which the fused
// trajectory core's forward (trajectory_block.cu) shares; this source calls
// it with one head of C = 64 channels and B = BH, as [BH, S, d] /
// [BH, F, N, d] / [BH, S, F, d] tensors: a persistent grid of one block an
// SM walking (bh, 128-query tile) units, a producer warpgroup filling a TMA
// ring of K_f / V_f frame slots, two ping-pong consumer warpgroups running
// Q K^T and P V on wgmma with the softmax on the accumulator registers, and
// TMA output stores. At N = 196 and 200 the keys pad to 208 (one m64n208
// wgmma), three K/V slots fit beside the Q ring and the staging tiles (227
// KB), one block an SM.
//
// Past 256 keys a frame (N <= 512: the learned-v model at the 336 crop, N =
// 441) the header's chunked form runs, kernel 1's at N > 256: two chunks of
// 224 keys a frame (256 past N = 448), a ring slot a chunk, the softmax
// online across the chunks, the weights rounded unnormalised and the
// frame's sums scaled by 1 / l (the TPU kernel, and this one at N <= 256,
// normalise before the rounding). Bound at BH = 48, S = 3528, N = 441:
// 152.9 GFLOP (0.155 ms) against 238 MB (0.071 ms), so operations.

#include "space_stage_core.cuh"

// q [BH, S, d]; kf, vf [BH, F, N, d]; out [BH, S, F, d]; all bf16 and
// contiguous from 16-byte boundaries, with S = F * N, d = 64, N <= 512.
// Launches one kernel on ``stream`` and returns the first cudaError_t met.
extern "C" int space_stage_bf16(const void* q, const void* kf, const void* vf,
                                void* out, int BH, int S, int F, int N, int d,
                                float scale, void* stream) {
  if (BH <= 0 || N <= 0 || N > SS_MAX_KEYS || F <= 0 || S != F * N ||
      d != SS_HD || !aligned16(q) || !aligned16(kf) || !aligned16(vf) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const auto* q_ = static_cast<const bf16*>(q);
  const auto* kf_ = static_cast<const bf16*>(kf);
  const auto* vf_ = static_cast<const bf16*>(vf);
  auto* out_ = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > SS_MAX_NP)
    return (int)launch_space_stage_chunked(q_, kf_, vf_, out_, BH, 1, S, F, N,
                                           scale, st);
  return (int)launch_space_stage_keys(q_, kf_, vf_, out_, BH, 1, S, F, N,
                                      scale, st);
}
