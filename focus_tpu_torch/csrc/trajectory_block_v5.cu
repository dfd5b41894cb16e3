// Trajectory core, forward version 5, for Hopper (sm_90a), non-CLS tokens.
//
// Replaces the TPU kernel focus_tpu/ops/pallas/trajectory_block.py
// (_fused_kernel_v5, called through _fused_fwd_pallas_v5 under
// FWD_VERSION = 5): fully frame-batched, the per-frame aggregates xs are
// never formed. Stage 1 writes only the own-frame aggregates x_diag, q2 =
// x_diag . Wq2 + bq2, the stage-2 logits are read off M_h = q2_h . k2v_h^T
// and the stage-1 weights (k2v = V . Wk2), and the temporal weights fold
// into the stage-1 ones: out_h = (p a2_f / s_f) . V_h over all F x N keys.
// The shared parts and the launch sequence (four launches) are in
// trajectory_k2v.cuh, which also states where the k2v identity holds. The
// backward kernel reads xs and q2, which this version does not keep:
// ops/trajectory_block.py recomputes them with version 4 first.
//
// Rounding points: the own-frame weights and x_diag, k2v, q2 and the folded
// weights p a2 / s are rounded to bf16; the stage-2 logits come from
// float32 p, a2 is float32; out is rounded once.
//
// Bound on this card: the same function as version 4, 0.0930 ms at B = 8,
// S = 1568 (operations). k2v (14.8 GFLOP at B = 8), M (30 GFLOP) and the
// logits computed twice in the stage-2 kernel (60 GFLOP) are work this
// variant chooses beyond it; the 154 MB xs round trip of version 4 is gone.

#include "trajectory_k2v.cuh"

// q [B, S, C]; kf, vf [B, F, N, C]; wq2, wk2 [C, C] ([in, out]); bq2 [C];
// scratch k2v [B, F * N, C], x_diag [B, S, C] and q2 [B, S, C]; out
// [B, S, C]; all bf16 and contiguous, S = F * N, C = heads * 64 (a
// multiple of 128), F <= 8, N <= 256, heads <= 16. The launches made go
// into *launched.
extern "C" int traj_core_v5_bf16(const void* q, const void* kf,
                                 const void* vf, const void* wq2,
                                 const void* bq2, const void* wk2, void* k2v,
                                 void* x_diag, void* q2, void* out,
                                 int* launched, int B, int S, int F, int N,
                                 int C, int heads, float scale,
                                 void* stream) {
  return traj_core_k2v<true>(q, kf, vf, wq2, bq2, wk2, k2v, x_diag, q2, out,
                             launched, B, S, F, N, C, heads, scale, stream);
}
