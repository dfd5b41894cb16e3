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
// with float32 sums on the tensor cores (mma.sync).
//
// It is the fused trajectory core's stage 1 (trajectory_core.cuh) with one
// head of 64 channels per row of q: one block per (bh, 128-query tile)
// loops over the F frames with frame f's K and V tiles ([N, 64] bf16 each,
// the keys padded to a multiple of 16 with zero rows whose logits are masked
// to -inf) in shared memory, copying the next frame's in while it uses
// this one's. The output is written directly in [BH, S, F, d]: the TPU
// kernel writes [BH, F, S, d] and transposes, a copy of the whole output.
//
// Bound on this card at BH = 96, S = 1568, F = 8, N = 196, d = 64: 60.4
// GFLOP (0.0611 ms at 989 TFLOP/s) against 211.9 MB (q, k, v 19.3 MB each,
// the output 154.1 MB: 0.0633 ms at 3.35 TB/s), so it is bound by bytes,
// three quarters of them the output's; the design writes each output byte
// once and reads each K/V frame once per query tile (from L2 after the
// first tile).

#include "trajectory_core.cuh"

// q [BH, S, d]; kf, vf [BH, F, N, d]; out [BH, S, F, d]; all bf16 and
// contiguous, with S = F * N, d = 64, N <= 256. Launches one kernel
// on ``stream`` and returns the first cudaError_t met.
extern "C" int space_stage_bf16(const void* q, const void* kf, const void* vf,
                                void* out, int BH, int S, int F, int N, int d,
                                float scale, void* stream) {
  if (BH <= 0 || N <= 0 || N > MAX_NP || F <= 0 || S != F * N || d != HD)
    return (int)cudaErrorInvalidValue;
  return (int)launch_stage1<false>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kf),
      static_cast<const bf16*>(vf), static_cast<bf16*>(out), BH, S, F, N, HD,
      1, scale, static_cast<cudaStream_t>(stream));
}
