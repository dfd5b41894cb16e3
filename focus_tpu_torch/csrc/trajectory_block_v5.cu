// Trajectory core, forward version 5, for Hopper (sm_90a), non-CLS tokens.
//
// Replaces the TPU kernel focus_tpu/ops/pallas/trajectory_block.py:872
// (_fused_kernel_v5, called through _fused_fwd_pallas_v5 under
// FWD_VERSION = 5): fully frame-batched, the per-frame aggregates xs are
// never formed. The design, shared with version 6 and told apart by one
// flag, is in trajectory_k2v.cuh: k2v = V . Wk2, the own-frame aggregates
// x_diag, q2 = x_diag . Wq2 + bq2, then one wgmma / TMA pass over the
// frames that reads the stage-2 logits off Y_f = P . k2v_f (the TPU
// kernel's M_h = q2_h . k2v_h^T is never formed) and mixes O_f = P . V_f
// with an online softmax over frames (four launches). Version 5 mixes the
// float32 O_f and stores no xs; the backward kernel reads xs and q2, which
// this version does not keep: ops/trajectory_block.py recomputes them with
// version 4 first.
//
// Rounding points (trajectory_core_k2v_mirror in ops/trajectory_block.py):
// k2v, the normalised stage-1 weights P (past 256 keys a frame the
// unnormalised ones, the products' sums scaled by 1 / l), x_diag and q2
// are rounded to bf16;
// O_f, Y_f, the stage-2 logits and the frame softmax stay float32; out is
// rounded once. The TPU kernel folds p a2 / s into bf16 weights instead.
//
// Bounds on this card at B = 8, S = 1568, 12 heads: 0.1219 ms for the
// function in its k2v form (120.5 GFLOP at 989 TFLOP/s, operations; the
// own-frame launch adds 7.6 that the pass also does); 0.0930 ms for the
// function of version 4. The first design (an mma.sync stage 1 and an
// M-form stage 2 that computed the logits twice) did 158 GFLOP.

#include "trajectory_k2v.cuh"

// q [B, S, C]; kf, vf [B, F, N, C]; wq2, wk2 [C, C] ([in, out]); bq2 [C];
// scratch k2v [B, F * N, C], x_diag [B, S, C] and q2 [B, S, C]; out
// [B, S, C]; all bf16 and contiguous, S = F * N, C = heads * 64 (a
// multiple of 128), F <= 8, N <= 512 (past 256 the chunked own-frame
// launch and pass), heads <= 16. The launches made go into *launched.
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
