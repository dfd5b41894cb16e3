// Trajectory core, forward version 6, for Hopper (sm_90a), non-CLS tokens.
//
// Replaces the TPU kernel focus_tpu/ops/pallas/trajectory_block.py
// (_fused_kernel_v6, called through _fused_fwd_pallas_v6 under
// FWD_VERSION = 6): version 4's structure with the stage-2 logits read off
// M_h = q2_h . k2v_h^T and the stage-1 weights, k2v = V . Wk2, in place of
// version 4's (q2_h . Wk2_h^T) . xs_f. Stage 1 writes xs, q2 is gathered
// from it, and the final mix sum_f a2_f xs_f is version 4's, so the
// backward kernel reads this kernel's xs and q2 as it reads version 4's.
// The shared parts and the launch sequence (four launches) are in
// trajectory_k2v.cuh, which also states where the k2v identity holds.
//
// Rounding points: stage-1 weights, xs, k2v and q2 are rounded to bf16 as
// version 4 rounds them; the stage-2 logits come from float32 p and the
// stage-2 weights a2 stay float32 (the TPU kernel's), out is rounded once.
//
// Bound on this card: the same function as version 4, 0.0930 ms at B = 8,
// S = 1568 (operations). The k2v product (14.8 GFLOP at B = 8), M (30 GFLOP)
// and the recomputed stage-1 logits (30 GFLOP) are work this variant
// chooses beyond it.

#include "trajectory_k2v.cuh"

// q [B, S, C]; kf, vf [B, F, N, C]; wq2, wk2 [C, C] ([in, out]); bq2 [C];
// scratch k2v [B, F * N, C], xs [B, S, F, C] and q2 [B, S, C]; out
// [B, S, C]; all bf16 and contiguous, S = F * N, C = heads * 64 (a
// multiple of 128), F <= 8, N <= 256, heads <= 16. The launches made go
// into *launched.
extern "C" int traj_core_v6_bf16(const void* q, const void* kf,
                                 const void* vf, const void* wq2,
                                 const void* bq2, const void* wk2, void* k2v,
                                 void* xs, void* q2, void* out, int* launched,
                                 int B, int S, int F, int N, int C, int heads,
                                 float scale, void* stream) {
  return traj_core_k2v<false>(q, kf, vf, wq2, bq2, wk2, k2v, xs, q2, out,
                              launched, B, S, F, N, C, heads, scale, stream);
}
