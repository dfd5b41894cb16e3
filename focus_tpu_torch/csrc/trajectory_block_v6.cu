// Trajectory core, forward version 6, for Hopper (sm_90a), non-CLS tokens.
//
// Replaces the TPU kernel focus_tpu/ops/pallas/trajectory_block.py:711
// (_fused_kernel_v6, called through _fused_fwd_pallas_v6 under
// FWD_VERSION = 6): version 4's structure with the stage-2 logits read off
// k2v = V . Wk2 in place of version 4's (q2_h . Wk2_h^T) . xs_f. The
// design, shared with version 5 and told apart by one flag, is in
// trajectory_k2v.cuh: k2v, the own-frame aggregates x_diag (parked in out),
// q2 = x_diag . Wq2 + bq2, then one wgmma / TMA pass over the frames that
// reads the stage-2 logits off Y_f = P . k2v_f and mixes with an online
// softmax over frames (four launches). Version 6 stores xs_f = bf16(P .
// V_f) by TMA and mixes those rounded values, so the backward kernel reads
// this kernel's xs and q2 as it reads version 4's; xs's own-frame rows are
// x_diag's bits, so the q2 it reads belongs to the xs it reads.
//
// Rounding points (trajectory_core_k2v_mirror in ops/trajectory_block.py):
// k2v, the normalised stage-1 weights P (past 256 keys a frame the
// unnormalised ones, the products' sums scaled by 1 / l), xs and q2 are
// rounded to bf16;
// Y_f, the stage-2 logits and the frame softmax stay float32; out is
// rounded once.
//
// Bounds on this card at B = 8, S = 1568, 12 heads: 0.1219 ms for the
// function in its k2v form (120.5 GFLOP at 989 TFLOP/s, operations; the
// own-frame launch adds 7.6 that the pass also does; the 154 MB xs store
// alone is 0.046 ms at 3.35 TB/s); 0.0930 ms for the function of version
// 4. The first design (an mma.sync stage 1 and an M-form stage 2
// that recomputed the logits) did 150 GFLOP.

#include "trajectory_k2v.cuh"

// q [B, S, C]; kf, vf [B, F, N, C]; wq2, wk2 [C, C] ([in, out]); bq2 [C];
// scratch k2v [B, F * N, C], xs [B, S, F, C] and q2 [B, S, C]; out
// [B, S, C]; all bf16 and contiguous, S = F * N, C = heads * 64 (a
// multiple of 128), F <= 8, N <= 512 (past 256 the chunked own-frame
// launch and pass), heads <= 16. The launches made go into *launched.
extern "C" int traj_core_v6_bf16(const void* q, const void* kf,
                                 const void* vf, const void* wq2,
                                 const void* bq2, const void* wk2, void* k2v,
                                 void* xs, void* q2, void* out, int* launched,
                                 int B, int S, int F, int N, int C, int heads,
                                 float scale, void* stream) {
  return traj_core_k2v<false>(q, kf, vf, wq2, bq2, wk2, k2v, xs, q2, out,
                              launched, B, S, F, N, C, heads, scale, stream);
}
