// Fused trajectory-attention core for Hopper (sm_90a), non-CLS tokens.
//
// Replaces the TPU kernel focus_tpu/ops/pallas/trajectory_block.py
// (_fused_kernel_v4, called through _fused_fwd_pallas_v4 /
// fused_trajectory_core). Same function, three launches:
//
//   stage 1 (one block per batch row, head and 128-query tile): for every
//     frame f, a true max-subtracted softmax of q . k_f^T * scale over that
//     frame's N keys, then P . v_f, written as xs[b, s, f, head] in bf16.
//     Each warp owns 16 query rows and keeps their logits for a whole frame
//     in registers (mma.sync m16n8k16, ldmatrix from the frame's K/V tiles
//     in shared memory); the softmax runs on those registers and the bf16
//     weights feed the PV product directly as A fragments.
//   stage 2a (a tiled GEMM): q2 = x_diag . Wq2 + bq2, where the own-frame
//     row x_diag = xs[b, s, s / N] is gathered as the tiles are copied in.
//   stage 2b (one block per 64 query rows and group of heads): per head
//     g_h = q2_h . Wk2[:, h]^T, logits g_h . xs[f] over all C channels
//     times scale, a softmax over the F frames, and sum_f a2[f] xs[f, h].
//     The k2 bias is constant over frames and drops out of that softmax.
//
// Rounding points follow the plain version at bf16 (ops/attention.py):
// stage-1 weights, xs, q2, g and the stage-2 weights are rounded to bf16;
// every product accumulates in float32 (the matrix products on the tensor
// cores with mma.sync).
//
// Bound on this card: ~92 GFLOP per call at the flagship shape (B = 8,
// S = 1568) against ~60 MB of inputs and outputs, so it is bound by
// operations. The catch for a design is that stage-2 logits for one head
// contract against all C channels of xs, so every head's stage 2 needs every
// head's stage 1. This version keeps xs in a bf16 scratch in device memory
// ([B, S, F, C], ~154 MB at B = 8; q2 adds ~19 MB) between the launches;
// keeping it on chip as the TPU kernel does, with TMA and wgmma, is later
// work. Stage 1 and the GEMM live in trajectory_core.cuh, shared with the
// v5 and v6 forward kernels and the space-stage kernel.

#include "trajectory_core.cuh"

namespace {

constexpr int THREADS = 128;     // stage 2b

// ---- stage 2b: stage-2 logits, F-softmax and the weighted sum ------------
// One block per 64 flattened rows (4 warps of 16 rows) and group of up to
// MAX_HPG heads: the output channels of head h need only that head's
// weights, so the heads are split over blocks to give the card enough
// warps. A warp keeps its rows' q2 fragments for the group's heads in
// registers. For each 32-channel chunk of xs, the chunk and the matching
// rows of Wk2 are copied to shared memory; per head, a warp forms its rows'
// g_h chunk = q2_h . Wk2[chunk, h]^T with mma.sync, rounds it to bf16 and
// dots it with the chunk for every frame. Each thread keeps its partial
// logits in registers across chunks; the four lanes sharing a row add
// theirs once at the end. Shared memory: XC [64][F * LDC + 8] bf16 (the
// extra 8 spread a row's reads over the banks) | LG [64][heads per
// group][MAX_F] float | WK [32][heads per group * 64 + 8] bf16.

constexpr int S2_ROWS = 64;
constexpr int S2_CH = 32;          // xs channels per chunk
constexpr int LDC = S2_CH + 8;
constexpr int MAX_HPG = 3;          // heads per block

__host__ __device__ inline int head_groups(int heads) {
  return (heads + MAX_HPG - 1) / MAX_HPG;
}

__host__ __device__ inline int heads_per_group(int heads) {
  return (heads + head_groups(heads) - 1) / head_groups(heads);
}

__host__ __device__ inline size_t stage2_xc_bytes(int F) {
  return round_up((size_t)S2_ROWS * (F * LDC + 8) * sizeof(bf16), 128);
}

__host__ __device__ inline size_t stage2_lg_bytes(int hpg) {
  return round_up((size_t)S2_ROWS * hpg * MAX_F * sizeof(float), 128);
}

__host__ __device__ inline size_t stage2_smem(int F, int hpg) {
  return stage2_xc_bytes(F) + stage2_lg_bytes(hpg) +
         (size_t)S2_CH * (hpg * HD + 8) * sizeof(bf16);
}

__global__ void __launch_bounds__(THREADS) traj_stage2_kernel(
    const bf16* __restrict__ xs, const bf16* __restrict__ q2,
    const bf16* __restrict__ wk2, bf16* __restrict__ out, int M, int F, int C,
    int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hpg = heads_per_group(heads);
  const int h0 = blockIdx.x * hpg, h1 = min(h0 + hpg, heads);
  if (h0 >= h1) return;
  const int XCR = F * LDC + 8, LDW = (h1 - h0) * HD + 8;
  bf16* XC = reinterpret_cast<bf16*>(smem);
  float* LG = reinterpret_cast<float*>(smem + stage2_xc_bytes(F));
  bf16* WK = reinterpret_cast<bf16*>(smem + stage2_xc_bytes(F) +
                                     stage2_lg_bytes(hpg));

  const int m0 = blockIdx.y * S2_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's block rows

  // q2 A fragments of rows r0 / r1 for every head of the group
  uint32_t a[MAX_HPG][HD / 16][4];
  {
    const bool ok0 = m0 + r0 < M, ok1 = m0 + r1 < M;
    const bf16* q2r0 = q2 + (size_t)(m0 + r0) * C + 2 * t;
    const bf16* q2r1 = q2 + (size_t)(m0 + r1) * C + 2 * t;
#pragma unroll
    for (int hi = 0; hi < MAX_HPG; ++hi)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int col = (h0 + hi) * HD + kk * 16;
        const bool live = h0 + hi < h1;
        a[hi][kk][0] = live && ok0 ? ldg32(q2r0 + col) : 0u;
        a[hi][kk][1] = live && ok1 ? ldg32(q2r1 + col) : 0u;
        a[hi][kk][2] = live && ok0 ? ldg32(q2r0 + col + 8) : 0u;
        a[hi][kk][3] = live && ok1 ? ldg32(q2r1 + col + 8) : 0u;
      }
  }

  // partial logits of rows r0 / r1 over this thread's columns
  float part[MAX_HPG][MAX_F][2];
#pragma unroll
  for (int hi = 0; hi < MAX_HPG; ++hi)
#pragma unroll
    for (int f = 0; f < MAX_F; ++f) part[hi][f][0] = part[hi][f][1] = 0.0f;

  for (int cc = 0; cc < C; cc += S2_CH) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < S2_ROWS * F * (S2_CH / 8); i += THREADS) {
      const int r = i / (F * (S2_CH / 8)), rem = i % (F * (S2_CH / 8));
      const int f = rem / (S2_CH / 8), c8 = (rem % (S2_CH / 8)) * 8;
      const int m = m0 + r;
      bf16* dst = XC + r * XCR + f * LDC + c8;
      if (m < M) copy16(dst, xs + ((size_t)m * F + f) * C + cc + c8);
      else zero16(dst);
    }
    const int w8 = (h1 - h0) * HD / 8;
    for (int i = tid; i < S2_CH * w8; i += THREADS) {
      const int r = i / w8, c8 = (i % w8) * 8;
      copy16(WK + r * LDW + c8, wk2 + (size_t)(cc + r) * C + h0 * HD + c8);
    }
    __syncthreads();
#pragma unroll
    for (int hi = 0; hi < MAX_HPG; ++hi) {
      if (h0 + hi >= h1) break;
      // g[r, cc + 8j + 2t + {0, 1}] for rows r0 (elements 0, 1), r1 (2, 3)
      float acc[S2_CH / 8][4];
#pragma unroll
      for (int j = 0; j < S2_CH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
      for (int jp = 0; jp < S2_CH / 16; ++jp)
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t kb[4];
          ldmatrix_x4(kb, WK + (jp * 16 + (lane & 7) + 8 * (lane >> 4)) * LDW +
                              hi * HD + kk * 16 + 8 * ((lane >> 3) & 1));
          mma_16816(acc[2 * jp], a[hi][kk], kb[0], kb[1]);
          mma_16816(acc[2 * jp + 1], a[hi][kk], kb[2], kb[3]);
        }
#pragma unroll
      for (int j = 0; j < S2_CH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = round_bf16(acc[j][e]);
      const bf16* x0 = XC + r0 * XCR + 2 * t;
      const bf16* x1 = XC + r1 * XCR + 2 * t;
#pragma unroll
      for (int f = 0; f < MAX_F; ++f) {
        if (f >= F) break;
#pragma unroll
        for (int j = 0; j < S2_CH / 8; ++j) {
          const float2 xa = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x0 + f * LDC + 8 * j));
          const float2 xb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x1 + f * LDC + 8 * j));
          part[hi][f][0] = fmaf(acc[j][0], xa.x, fmaf(acc[j][1], xa.y, part[hi][f][0]));
          part[hi][f][1] = fmaf(acc[j][2], xb.x, fmaf(acc[j][3], xb.y, part[hi][f][1]));
        }
      }
    }
  }

  // the four lanes of a quad hold one row's columns: add their partials
#pragma unroll
  for (int hi = 0; hi < MAX_HPG; ++hi) {
    if (h0 + hi >= h1) break;
#pragma unroll
    for (int f = 0; f < MAX_F; ++f) {
      if (f >= F) break;
      float p0 = part[hi][f][0], p1 = part[hi][f][1];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        p0 += __shfl_xor_sync(0xffffffffu, p0, o);
        p1 += __shfl_xor_sync(0xffffffffu, p1, o);
      }
      if ((f & 3) == t) {
        LG[(r0 * hpg + hi) * MAX_F + f] = p0;
        LG[(r1 * hpg + hi) * MAX_F + f] = p1;
      }
    }
  }
  __syncthreads();

  // softmax over frames -> bf16-rounded weights, in place
  for (int p = tid; p < S2_ROWS * (h1 - h0); p += THREADS) {
    float* l = LG + ((p / (h1 - h0)) * hpg + p % (h1 - h0)) * MAX_F;
    float mx = -INFINITY;
    for (int f = 0; f < F; ++f) mx = fmaxf(mx, l[f] * scale);
    float sum = 0.0f;
    for (int f = 0; f < F; ++f) sum += expf(l[f] * scale - mx);
    for (int f = 0; f < F; ++f) l[f] = round_bf16(expf(l[f] * scale - mx) / sum);
  }
  __syncthreads();

  // out[m, c] = sum_f a2[m, head(c), f] * xs[m, f, c] for this group's
  // channels, 8 channels a thread
  const int c8n = (h1 - h0) * HD / 8;
  for (int i = tid; i < S2_ROWS * c8n; i += THREADS) {
    const int r = i / c8n, c8 = h0 * HD + (i % c8n) * 8, m = m0 + r;
    if (m >= M) continue;
    const float* a2 = LG + (r * hpg + (c8 / HD - h0)) * MAX_F;
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = 0.0f;
    for (int f = 0; f < F; ++f) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(xs + ((size_t)m * F + f) * C + c8);
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = fmaf(a2[f], __bfloat162float(xv[j]), o[j]);
    }
    uint4 packed;
    bf16* ov = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) ov[j] = __float2bfloat16(o[j]);
    *reinterpret_cast<uint4*>(out + (size_t)m * C + c8) = packed;
  }
}

}  // namespace

// q [B, S, C]; kf, vf [B, F, N, C]; wq2, wk2 [C, C] ([in, out]); bq2 [C];
// scratch xs [B, S, F, C] and q2 [B, S, C]; out [B, S, C]; all bf16 and
// contiguous, with S = F * N, C = heads * 64 (a multiple of 128),
// F <= 8, N <= 256, heads <= 16. Launches the three stages on ``stream``
// and returns the first cudaError_t met.
extern "C" int traj_core_bf16(const void* q, const void* kf, const void* vf,
                              const void* wq2, const void* bq2,
                              const void* wk2, void* xs, void* q2, void* out,
                              int B, int S, int F, int N, int C, int heads,
                              float scale, void* stream) {
  if (B <= 0 || N <= 0 || N > MAX_NP || F <= 0 || F > MAX_F || S != F * N ||
      heads <= 0 || heads > MAX_HEADS || C != heads * HD || C % GN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;

  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* kf_ = static_cast<const bf16*>(kf);
  const bf16* vf_ = static_cast<const bf16*>(vf);
  bf16* xs_ = static_cast<bf16*>(xs);
  err = launch_stage1<false>(q_, kf_, vf_, xs_, B, S, F, N, C, heads, scale,
                             st);
  if (err != cudaSuccess) return (int)err;

  const int M = B * S;
  err = launch_gemm(xs_, static_cast<const bf16*>(wq2),
                    static_cast<const bf16*>(bq2), static_cast<bf16*>(q2), M,
                    S, F, N, C, st);
  if (err != cudaSuccess) return (int)err;

  const size_t smem2 = stage2_smem(F, heads_per_group(heads));
  err = cudaFuncSetAttribute(traj_stage2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(head_groups(heads), (M + S2_ROWS - 1) / S2_ROWS);
  traj_stage2_kernel<<<g2, THREADS, smem2, st>>>(
      xs_, static_cast<const bf16*>(q2), static_cast<const bf16*>(wk2),
      static_cast<bf16*>(out), M, F, C, heads, scale);
  return (int)cudaGetLastError();
}
