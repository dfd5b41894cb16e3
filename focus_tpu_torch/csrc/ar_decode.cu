// One fused autoregressive decode step of the STEVE slot rollout, for
// NVIDIA Hopper (sm_90a), bf16 operands with float32 accumulation.
//
// Replaces the TPU kernel focus_tpu/ops/pallas/ar_decode.py:_ar_step_kernel
// (one pallas_call over a (layer, 14 stages) grid). It computes the same
// function; the grid is not carried over, because it exists to keep the
// TPU's weight DMA pipeline full and blocks on this card run in no order.
// One step is a fixed sequence of launches on one stream (11 per layer + 3):
//
//   layernorm_kernel      position row t added and layer 0's residual stream
//                         started from the normed input; later the three
//                         pre-LayerNorms of a layer and the final one;
//   skinny_gemm_kernel    out[M, N] = a[M, K] . w[N, K]^T for M <= 64 rows a
//                         block (row tiles above that): q|k|v (q scaled and
//                         rounded, the k and v rows written into cache row
//                         t), the two o-projections and fc2 (added into the
//                         float32 residual stream), cross q, fc1 (+bias,
//                         ReLU), the vocabulary logits;
//   attention_kernel      one block per (row, head): online softmax over
//                         cache rows [0, t], or over the S hoisted slot K/V;
//   argmax_gather_kernel  first-index argmax of a row's logits and the
//                         dictionary row of the argmax as the next input.
//
// Every launch goes through launch_pdl: cudaLaunchKernelEx with programmatic
// stream serialization (programmatic dependent launch, PDL), so that a
// kernel's blocks start while the kernel before it drains, and the card
// never waits on a launch. Each kernel first issues what does not depend on
// the kernel before it (its weight rows as bulk L2 prefetches, its bias,
// scales, LayerNorm gamma / beta and position row, the cross-attention's
// hoisted slot K/V), then executes griddepcontrol.wait, which returns once
// the kernel before it has completed and its writes are visible, and only
// then triggers its own dependents (griddepcontrol.launch_dependents) and
// reads the activations. Invariant: no kernel writes device memory, or reads
// anything an earlier kernel of the step writes, before its wait: the
// scratch buffers are reused from one kernel to the next, so a write before
// the wait could race the previous kernel's reads of the same bytes (and a
// read, its writes). A prefetch is only a hint to L2 and cannot change a
// result. The next kernel's blocks become resident beside the draining
// ones: a GEMM block keeps 256 threads and 17-68 KB of shared memory (its
// warps' partial tiles, at most 64 rows x 32 columns), the row kernels and
// the attention 256 threads and at most 33 KB, so at least two blocks of
// any two kernels of the step fit an SM together. The whole step, or a
// whole rollout of steps, can be captured into one CUDA graph
// (ops/ar_decode.py RolloutGraph): the programmatic edges are kept.
//
// The step index t is read from device memory, so the same launch sequence
// serves every step. Any vocabulary size, row count and head dim up to 1024
// are taken; every load is bounds-checked (`load8`), so nothing reads past a
// row, the caches' L rows or the vocabulary.
//
// Bound on this card: a step streams all 14 D^2 bf16 weights of every layer
// plus head and dictionary (0.97 GB at D = 2048, 8 layers) and the K/V rows
// <= t, against 2 FLOPs per weight and row (M = 32), far below the ~295
// FLOPs per byte where the tensor cores would bind: it is bound by bytes.
// The GEMM therefore splits a weight's output columns over all SMs so that
// each weight byte leaves device memory once per step (16 or 32 columns a
// block, the block's eight warps splitting K and adding their partial tiles
// in shared memory), reads weights and activations as 16-byte vectors
// straight into mma.sync m16n8k16 fragments (the k order inside a 32-wide
// chunk is permuted the same way for both operands, which leaves the dot
// products unchanged), keeps two to four chunks per warp loaded ahead in
// registers so that ~32 KB of weights are in flight on every SM, and leaves
// the activations, at most 64 rows, to L2.
//
// W8A8 mode (ar_decode_step_w8a8; the TPU kernel with int8=True): the same
// launch sequence over int8 weight codes with float32 scales per output
// column and JAX chunk. Every product quantizes its A operand per row,
// s = max(amax, 1e-8) * (1/127), codes round-half-even(a / s) with a true
// division: the LayerNorms emit the codes and scale of their output beside
// it, and one row-quantization launch each takes the self-attention
// context, the cross context and the FFN hidden (per D-wide group for fc2).
// The int8 GEMM (mma.sync m16n8k32 s8, a 16-byte load carrying 16 k values
// with the same permuted-k trick) sums its warps' partial tiles in int32,
// which is exact, and dequantizes once, float(acc) * s_row * s_col, in the
// epilogue; fc2's four K groups are each summed over their own warps and
// dequantized before they are added in group order, as the TPU kernel adds
// its chunk partials. The gather writes the dequantized dictionary row,
// (float(127 * code) * (1/127)) * scale, which is what the TPU kernel's
// one-hot W8A8 product gives. 14 launches a layer + 3. Bound: the weight
// stream halves (0.48 GB at D = 2048, 8 layers) against the bf16 step's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float LN_EPS = 1e-6f;
constexpr float QUANT_EPS = 1e-8f;
constexpr float INV127 = (float)(1.0 / 127.0);  // as the TPU kernel rounds it
constexpr int GEMM_WARPS = 8;      // the warps of a block split K
constexpr int GEMM_THREADS = 32 * GEMM_WARPS;
constexpr int GEMM_MAX_MT = 4;     // 16-row tiles a block holds: 64 rows
constexpr int GEMM_WIDE_BLOCKS = 120;  // 32-column blocks once N gives this many
constexpr int ROW_THREADS = 256;   // layernorm and argmax: one block per row
constexpr int LN_REG = 16;         // row values a layernorm thread keeps
constexpr int ATT_WARPS = 8;
constexpr int ATT_MAX_CHUNKS = 4;  // 256-wide head-dim chunks: head dim <= 1024

// Kernel launches of the step in progress on this host thread, and those of
// them made with the PDL attribute: launch_pdl adds to both, and the totals
// are handed back to the caller.
thread_local int step_launches = 0;
thread_local int step_pdl_launches = 0;

// The one way a kernel of the step is launched: with programmatic stream
// serialization, so that it may start before the kernel ahead of it has
// finished (its griddepcontrol.wait holds it back where it must).
template <typename... KArgs, typename... Args>
cudaError_t launch_pdl(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                       size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  ++step_launches;
  if (err == cudaSuccess) ++step_pdl_launches;
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Before the wait: hints that move constant operands toward L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// `bytes` (a multiple of 16) from a 16-byte aligned `p` toward L2
__device__ __forceinline__ void prefetch_l2_bulk(const void* p,
                                                 uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               :: "l"(p), "r"(bytes) : "memory");
}

// Waits until the kernel before this one in the stream has completed and
// its writes are visible; returns at once when there is none to wait for.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Lets the next kernel's blocks be scheduled (they stop at their own wait).
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Each thread of the block prefetches every 128-byte line of [p, p + n
// floats) it is given, 32 floats a line.
__device__ __forceinline__ void prefetch_floats(const float* p, int n) {
  for (int i = threadIdx.x * 32; i < n; i += blockDim.x * 32)
    prefetch_l2(p + i);
}

struct Vec8 {
  uint32_t w[4];  // eight bf16
};

// Eight consecutive bf16 of `row` from element e; elements at or beyond
// `limit` read as zero. One 16-byte load where it is whole and aligned.
__device__ __forceinline__ Vec8 load8(const bf16* row, int e, int limit) {
  Vec8 v;
  const bf16* p = row + e;
  if (e + 8 <= limit && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = u.x;
    v.w[1] = u.y;
    v.w[2] = u.z;
    v.w[3] = u.w;
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = (e + 2 * i < limit) ? s[2 * i] : 0u;
      const uint32_t hi = (e + 2 * i + 1 < limit) ? s[2 * i + 1] : 0u;
      v.w[i] = lo | (hi << 16);
    }
  }
  return v;
}

// The same for rows whose every 8-element group is whole and 16-byte aligned
// (row length a multiple of 8, aligned base): one predicated load, no branch,
// so a loop's loads can start ahead of the arithmetic that uses them.
template <bool VEC>
__device__ __forceinline__ Vec8 load8(const bf16* row, int e, int limit,
                                      bool valid) {
  if constexpr (VEC) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (valid && e < limit) u = __ldg(reinterpret_cast<const uint4*>(row + e));
    Vec8 v;
    v.w[0] = u.x;
    v.w[1] = u.y;
    v.w[2] = u.z;
    v.w[3] = u.w;
    return v;
  }
  return load8(row, e, valid ? limit : 0);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ Vec8 zero8() {
  Vec8 v;
  v.w[0] = v.w[1] = v.w[2] = v.w[3] = 0u;
  return v;
}

__device__ __forceinline__ void unpack8(const Vec8& v, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(v.w[i] << 16);
    f[2 * i + 1] = __uint_as_float(v.w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int clamp_step(const int* t, int L) {
  const int v = *t;
  return v < 0 ? 0 : (v >= L ? L - 1 : v);
}

// Sum over the block's threads; `red` holds one float per warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // `red` may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  return total;
}

// Maximum over the block's threads; `red` holds one float per warp.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

// The row scale of an A operand whose largest |value| is amax, and the code
// of a value: s = max(amax, 1e-8) * (1/127), round-half-even(a / s).
__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, QUANT_EPS), INV127);
}

__device__ __forceinline__ int8_t quant_code(float a, float s) {
  const int q = __float2int_rn(__fdiv_rn(a, s));
  return (int8_t)(q < -127 ? -127 : (q > 127 ? 127 : q));
}

// ---- row quantization (W8A8) -------------------------------------------------
// One block per (row, group) of a [rows, K] bf16 operand cut into `groups`
// runs of K / groups: the run's codes and its scale (scale[row, group]).

__global__ void __launch_bounds__(ROW_THREADS)
quantize_rows_kernel(const bf16* __restrict__ a, int K, int groups,
                     int8_t* __restrict__ q, float* __restrict__ scale) {
  __shared__ float red[ROW_THREADS / 32];
  pdl_wait();  // `a` is the kernel before's output
  pdl_trigger();
  const int kg = K / groups;
  const size_t base = (size_t)blockIdx.x * K + (size_t)blockIdx.y * kg;
  float amax = 0.f;
  for (int i = threadIdx.x; i < kg; i += ROW_THREADS)
    amax = fmaxf(amax, fabsf(__bfloat162float(a[base + i])));
  const float s = quant_scale(block_max(amax, red));
  for (int i = threadIdx.x; i < kg; i += ROW_THREADS)
    q[base + i] = quant_code(__bfloat162float(a[base + i]), s);
  if (threadIdx.x == 0) scale[(size_t)blockIdx.x * groups + blockIdx.y] = s;
}

cudaError_t launch_quantize_rows(const bf16* a, int rows, int K, int groups,
                                 int8_t* q, float* scale,
                                 cudaStream_t stream) {
  return launch_pdl(quantize_rows_kernel, dim3(rows, groups), dim3(ROW_THREADS),
                    0, stream, a, K, groups, q, scale);
}

// ---- LayerNorm -------------------------------------------------------------
// One block per row. first != 0: the input is x (bf16) + pos[t]; the normed
// row is the new float32 residual stream `xs` and its bf16 rounding `xn`
// (layer 0 starts from the normed input). first == 0: xn = bf16(LN(xs)).
// Mean, then the mean of squared deviations, as the TPU kernel's `_ln`. With
// REG a thread keeps its LN_REG values of the row in registers between the
// three passes (D <= ROW_THREADS * LN_REG); without, it reads them again.
// With xq (W8A8) the block also writes the int8 codes of xn and its row
// scale xscale[row], from the bf16-rounded values.

template <bool REG>
__global__ void __launch_bounds__(ROW_THREADS)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ pos,
                 const int* __restrict__ t, int L, float* xs,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, bf16* __restrict__ xn, int D,
                 int first, int8_t* __restrict__ xq,
                 float* __restrict__ xscale) {
  __shared__ float red[ROW_THREADS / 32];
  const size_t row = (size_t)blockIdx.x * D;
  // t, pos, gamma and beta are written by no kernel of the step
  const float* prow = first ? pos + (size_t)clamp_step(t, L) * D : nullptr;
  prefetch_floats(gamma, D);
  prefetch_floats(beta, D);
  if (first) prefetch_floats(prow, D);
  pdl_wait();
  pdl_trigger();
  auto value = [&](int i) {
    return first ? __bfloat162float(x[row + i]) + prow[i] : xs[row + i];
  };
  constexpr int NREG = REG ? LN_REG : 1;
  const int iters = REG ? LN_REG : (D + ROW_THREADS - 1) / ROW_THREADS;
  float v[NREG];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < iters; ++i) {
    const int idx = threadIdx.x + i * ROW_THREADS;
    const float val = idx < D ? value(idx) : 0.f;
    if constexpr (REG) v[i] = val;
    s += val;
  }
  const float mean = block_sum(s, red) / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < iters; ++i) {
    const int idx = threadIdx.x + i * ROW_THREADS;
    if (idx < D) {
      const float d = (REG ? v[i] : value(idx)) - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) / (float)D + LN_EPS);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < iters; ++i) {
    const int idx = threadIdx.x + i * ROW_THREADS;
    if (idx < D) {
      const float y =
          ((REG ? v[i] : value(idx)) - mean) * rstd * gamma[idx] + beta[idx];
      if (first) xs[row + idx] = y;
      const bf16 yb = __float2bfloat16_rn(y);
      xn[row + idx] = yb;
      const float yr = __bfloat162float(yb);
      if constexpr (REG) v[i] = yr;
      amax = fmaxf(amax, fabsf(yr));
    }
  }
  if (xq == nullptr) return;  // the same for the whole block
  const float qs = quant_scale(block_max(amax, red));
#pragma unroll
  for (int i = 0; i < iters; ++i) {
    const int idx = threadIdx.x + i * ROW_THREADS;
    if (idx < D)
      xq[row + idx] =
          quant_code(REG ? v[i] : __bfloat162float(xn[row + idx]), qs);
  }
  if (threadIdx.x == 0) xscale[blockIdx.x] = qs;
}

cudaError_t launch_layernorm(const bf16* x, const float* pos, const int* t,
                             int L, float* xs, const float* gamma,
                             const float* beta, bf16* xn, int rows, int D,
                             int first, int8_t* xq, float* xscale,
                             cudaStream_t stream) {
  return launch_pdl(D <= ROW_THREADS * LN_REG ? layernorm_kernel<true>
                                             : layernorm_kernel<false>,
                    dim3(rows), dim3(ROW_THREADS), 0, stream, x, pos, t, L,
                    xs, gamma, beta, xn, D, first, xq, xscale);
}

// ---- skinny GEMM -----------------------------------------------------------

enum Epilogue {
  EPI_QKV = 0,        // q scaled -> out_bf16; k, v -> cache row t
  EPI_RESIDUAL = 1,   // out_f32 += acc (+ bias)
  EPI_SCALE = 2,      // out_bf16 = acc * scale
  EPI_BIAS_RELU = 3,  // out_bf16 = relu(acc + bias)
  EPI_F32 = 4,        // out_f32 = acc
};

struct GemmArgs {
  const bf16* a;      // [M, K]
  const bf16* w;      // [N, K]
  int M, N, K;
  int epilogue;
  float scale;
  const float* bias;  // [N] or null
  float* out_f32;     // [M, N]
  bf16* out_bf16;     // [M, N], or q [M, D] for EPI_QKV
  bf16* k_rows;       // EPI_QKV: this layer's caches [L, M, D]
  bf16* v_rows;
  const int* t;
  int L, D;
  // W8A8 (skinny_gemm_s8_kernel): K is cut into `groups` runs of K / groups,
  // each with its own scales, dequantized before the runs are added
  const int8_t* aq;       // [M, K] codes
  const float* a_scale;   // [M, groups]
  const int8_t* wq;       // [N, K] codes
  const float* w_scale;   // [groups, N]
  int groups;
};

// The epilogue of output element (m, n) with value v (float32).
__device__ __forceinline__ void gemm_store(const GemmArgs& g, int m, int n,
                                           float v, int t) {
  const size_t o = (size_t)m * g.N + n;
  switch (g.epilogue) {
    case EPI_QKV: {
      const int which = n / g.D, col = n - which * g.D;
      if (which == 0) {
        g.out_bf16[(size_t)m * g.D + col] = __float2bfloat16_rn(v * g.scale);
      } else {
        bf16* rows = which == 1 ? g.k_rows : g.v_rows;
        rows[((size_t)t * g.M + m) * g.D + col] = __float2bfloat16_rn(v);
      }
      break;
    }
    case EPI_RESIDUAL:
      g.out_f32[o] += g.bias ? v + g.bias[n] : v;
      break;
    case EPI_SCALE:
      g.out_bf16[o] = __float2bfloat16_rn(v * g.scale);
      break;
    case EPI_BIAS_RELU:
      g.out_bf16[o] = __float2bfloat16_rn(fmaxf(v + g.bias[n], 0.f));
      break;
    default:
      g.out_f32[o] = v;
      break;
  }
}

// The register stages a warp keeps loaded ahead of its mma: more for small
// tiles, so that a block has ~32 KB of weights in flight.
__host__ __device__ constexpr int gemm_stages(int mt, int nt) {
  return mt * nt <= 4 ? 4 : (mt * nt <= 8 ? 3 : 2);
}

template <int MT, int NT>
__host__ __device__ constexpr size_t gemm_smem_bytes() {
  return (size_t)GEMM_WARPS * (16 * MT) * (8 * NT + 1) * sizeof(float);
}

template <int MT, int NT>
struct GemmFrag {
  Vec8 a[MT][2];  // rows gid and gid + 8 of each 16-row tile
  Vec8 b[NT];     // column gid of each 8-column tile
};

// Chunk c of the block's operands: a lane reads k = 32 c + 8 tig .. + 7 of its
// rows. A chunk at or past the end of K reads as zeros.
template <int MT, int NT, bool VEC>
__device__ __forceinline__ void gemm_load(GemmFrag<MT, NT>& f,
                                          const GemmArgs& g, int c, int m0,
                                          int n0, int gid, int tig) {
  const int k = c * 32 + tig * 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + nt * 8 + gid;
    f.b[nt] = load8<VEC>(g.w + (size_t)n * g.K, k, g.K, n < g.N);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = m0 + mt * 16 + gid, r1 = r0 + 8;
    f.a[mt][0] = load8<VEC>(g.a + (size_t)r0 * g.K, k, g.K, r0 < g.M);
    f.a[mt][1] = load8<VEC>(g.a + (size_t)r1 * g.K, k, g.K, r1 < g.M);
  }
}

template <int MT, int NT, bool VEC>
__global__ void __launch_bounds__(GEMM_THREADS)
skinny_gemm_kernel(const GemmArgs g) {
  constexpr int BM = 16 * MT;
  constexpr int BN = 8 * NT;
  constexpr int STAGES = gemm_stages(MT, NT);
  extern __shared__ float gemm_red[];  // [GEMM_WARPS][BM][BN + 1]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = g.M, N = g.N;

  // before the wait: the block's weight rows (one bulk prefetch a row; the
  // row tiles of a 128-row product share them) and bias
  if (blockIdx.y == 0 && (int)threadIdx.x < BN && n0 + (int)threadIdx.x < N) {
    const int n = n0 + threadIdx.x;
    if (VEC) prefetch_l2_bulk(g.w + (size_t)n * g.K, (uint32_t)g.K * 2u);
    if (g.bias) prefetch_l2(g.bias + n);
  }
  pdl_wait();

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // Warp w takes the 32-wide k chunks w, w + GEMM_WARPS, ...; STAGES of them
  // are held in registers, each reloaded as soon as it has been used. Of a
  // lane's eight k values, words 0, 1 feed the chunk's first mma and words
  // 2, 3 the second, for A and B alike.
  const int nchunks = (g.K + 31) / 32;
  GemmFrag<MT, NT> f[STAGES];
#pragma unroll
  for (int s = 0; s < STAGES; ++s)
    gemm_load<MT, NT, VEC>(f[s], g, warp + s * GEMM_WARPS, m0, n0, gid, tig);
  pdl_trigger();
  for (int c = warp; c < nchunks; c += GEMM_WARPS * STAGES) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_16816(acc[mt][nt], f[s].a[mt][0].w[0], f[s].a[mt][1].w[0],
                    f[s].a[mt][0].w[1], f[s].a[mt][1].w[1], f[s].b[nt].w[0],
                    f[s].b[nt].w[1]);
          mma_16816(acc[mt][nt], f[s].a[mt][0].w[2], f[s].a[mt][1].w[2],
                    f[s].a[mt][0].w[3], f[s].a[mt][1].w[3], f[s].b[nt].w[2],
                    f[s].b[nt].w[3]);
        }
      gemm_load<MT, NT, VEC>(f[s], g, c + (s + STAGES) * GEMM_WARPS, m0, n0,
                             gid, tig);
    }
  }

  auto red = [&](int w, int r, int c) -> float& {
    return gemm_red[((size_t)w * BM + r) * (BN + 1) + c];
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = mt * 16 + gid, c = nt * 8 + tig * 2;
      red(warp, r, c) = acc[mt][nt][0];
      red(warp, r, c + 1) = acc[mt][nt][1];
      red(warp, r + 8, c) = acc[mt][nt][2];
      red(warp, r + 8, c + 1) = acc[mt][nt][3];
    }
  __syncthreads();

  const int t = g.epilogue == EPI_QKV ? clamp_step(g.t, g.L) : 0;
  for (int idx = threadIdx.x; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = red(0, r, c);
#pragma unroll
    for (int w = 1; w < GEMM_WARPS; ++w) v += red(w, r, c);
    gemm_store(g, m, n, v, t);
  }
}

template <int MT, int NT, bool VEC>
cudaError_t launch_gemm_tile(const GemmArgs& g, cudaStream_t stream) {
  constexpr size_t smem = gemm_smem_bytes<MT, NT>();
  if (smem > 48 * 1024) {  // above the default limit: asked for once
    static cudaError_t attr = cudaFuncSetAttribute(
        skinny_gemm_kernel<MT, NT, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid((g.N + 8 * NT - 1) / (8 * NT), (g.M + 16 * MT - 1) / (16 * MT));
  return launch_pdl(skinny_gemm_kernel<MT, NT, VEC>, grid, dim3(GEMM_THREADS),
                    smem, stream, g);
}

template <int NT, bool VEC>
cudaError_t launch_gemm_rows(const GemmArgs& g, cudaStream_t stream) {
  const int mt = (g.M + 15) / 16;
  switch (mt < GEMM_MAX_MT ? mt : GEMM_MAX_MT) {
    case 1: return launch_gemm_tile<1, NT, VEC>(g, stream);
    case 2: return launch_gemm_tile<2, NT, VEC>(g, stream);
    case 3: return launch_gemm_tile<3, NT, VEC>(g, stream);
    default: return launch_gemm_tile<4, NT, VEC>(g, stream);
  }
}

cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  // 32 columns a block halve the activation re-reads; taken once that
  // still leaves a block for (nearly) every SM
  const bool wide = (g.N + 31) / 32 >= GEMM_WIDE_BLOCKS;
  const bool vec = g.K % 8 == 0 && aligned16(g.a) && aligned16(g.w);
  if (wide) {
    return vec ? launch_gemm_rows<4, true>(g, stream)
               : launch_gemm_rows<4, false>(g, stream);
  }
  return vec ? launch_gemm_rows<2, true>(g, stream)
             : launch_gemm_rows<2, false>(g, stream);
}

// ---- skinny int8 GEMM (W8A8) -------------------------------------------------
// The bf16 kernel's blocking over int8 codes: mma.sync m16n8k32 s8 with int32
// accumulators, a lane's 16-byte load carrying 16 k values of a 64-wide
// chunk (words 0, 1 feed the chunk's first mma, words 2, 3 the second, for A
// and B alike). The warps are split evenly over the K groups (fc2: 2 warps
// for each of its 4 D-wide groups; 1 group elsewhere), and each warp walks
// the chunks of its own group only.

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Sixteen consecutive int8 of `row` from element e; elements at or beyond
// `limit`, or of an invalid row, read as zero. VEC: every 16-element group
// is whole and 16-byte aligned (one predicated load).
template <bool VEC>
__device__ __forceinline__ Vec8 load16s8(const int8_t* row, int e, int limit,
                                         bool valid) {
  Vec8 v;
  if constexpr (VEC) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (valid && e < limit) u = __ldg(reinterpret_cast<const uint4*>(row + e));
    v.w[0] = u.x;
    v.w[1] = u.y;
    v.w[2] = u.z;
    v.w[3] = u.w;
    return v;
  }
  const unsigned char* p = reinterpret_cast<const unsigned char*>(row);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int k = e + 4 * i + b;
      if (valid && k < limit) word |= (uint32_t)p[k] << (8 * b);
    }
    v.w[i] = word;
  }
  return v;
}

// Chunk c of a K run [k_lo, k_hi): a lane reads k = k_lo + 64 c + 16 tig ..
// + 15 of its rows; past k_hi it reads zeros.
template <int MT, int NT, bool VEC>
__device__ __forceinline__ void gemm_s8_load(GemmFrag<MT, NT>& f,
                                             const GemmArgs& g, int c,
                                             int k_lo, int k_hi, int m0,
                                             int n0, int gid, int tig) {
  const int k = k_lo + c * 64 + tig * 16;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + nt * 8 + gid;
    f.b[nt] = load16s8<VEC>(g.wq + (size_t)n * g.K, k, k_hi, n < g.N);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = m0 + mt * 16 + gid, r1 = r0 + 8;
    f.a[mt][0] = load16s8<VEC>(g.aq + (size_t)r0 * g.K, k, k_hi, r0 < g.M);
    f.a[mt][1] = load16s8<VEC>(g.aq + (size_t)r1 * g.K, k, k_hi, r1 < g.M);
  }
}

template <int MT, int NT, bool VEC>
__global__ void __launch_bounds__(GEMM_THREADS)
skinny_gemm_s8_kernel(const GemmArgs g) {
  constexpr int BM = 16 * MT;
  constexpr int BN = 8 * NT;
  constexpr int STAGES = gemm_stages(MT, NT);
  extern __shared__ int gemm_red_s32[];  // [GEMM_WARPS][BM][BN + 1]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = g.M, N = g.N;
  const int wpg = GEMM_WARPS / g.groups;  // warps per K group
  const int kg = g.K / g.groups;
  const int k_lo = (warp / wpg) * kg, k_hi = k_lo + kg;
  const int w0 = warp % wpg;

  // before the wait: the block's weight-code rows, scales and bias
  if (blockIdx.y == 0 && (int)threadIdx.x < BN && n0 + (int)threadIdx.x < N) {
    const int n = n0 + threadIdx.x;
    if (VEC) prefetch_l2_bulk(g.wq + (size_t)n * g.K, (uint32_t)g.K);
    for (int gi = 0; gi < g.groups; ++gi)
      prefetch_l2(g.w_scale + (size_t)gi * N + n);
    if (g.bias) prefetch_l2(g.bias + n);
  }
  pdl_wait();

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  const int nchunks = (kg + 63) / 64;
  GemmFrag<MT, NT> f[STAGES];
#pragma unroll
  for (int s = 0; s < STAGES; ++s)
    gemm_s8_load<MT, NT, VEC>(f[s], g, w0 + s * wpg, k_lo, k_hi, m0, n0, gid,
                              tig);
  pdl_trigger();
  for (int c = w0; c < nchunks; c += wpg * STAGES) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_s8_16832(acc[mt][nt], f[s].a[mt][0].w[0], f[s].a[mt][1].w[0],
                       f[s].a[mt][0].w[1], f[s].a[mt][1].w[1],
                       f[s].b[nt].w[0], f[s].b[nt].w[1]);
          mma_s8_16832(acc[mt][nt], f[s].a[mt][0].w[2], f[s].a[mt][1].w[2],
                       f[s].a[mt][0].w[3], f[s].a[mt][1].w[3],
                       f[s].b[nt].w[2], f[s].b[nt].w[3]);
        }
      gemm_s8_load<MT, NT, VEC>(f[s], g, c + (s + STAGES) * wpg, k_lo, k_hi,
                                m0, n0, gid, tig);
    }
  }

  auto red = [&](int w, int r, int c) -> int& {
    return gemm_red_s32[((size_t)w * BM + r) * (BN + 1) + c];
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = mt * 16 + gid, c = nt * 8 + tig * 2;
      red(warp, r, c) = acc[mt][nt][0];
      red(warp, r, c + 1) = acc[mt][nt][1];
      red(warp, r + 8, c) = acc[mt][nt][2];
      red(warp, r + 8, c + 1) = acc[mt][nt][3];
    }
  __syncthreads();

  const int t = g.epilogue == EPI_QKV ? clamp_step(g.t, g.L) : 0;
  for (int idx = threadIdx.x; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    // each group: its warps' int32 partials (exact), then the dequant; the
    // groups' float32 parts are added in group order
    float v = 0.f;
    for (int gi = 0; gi < g.groups; ++gi) {
      int iv = 0;
      for (int w = gi * wpg; w < (gi + 1) * wpg; ++w) iv += red(w, r, c);
      const float part =
          __fmul_rn(__fmul_rn((float)iv, g.a_scale[(size_t)m * g.groups + gi]),
                    g.w_scale[(size_t)gi * N + n]);
      v = gi == 0 ? part : __fadd_rn(v, part);
    }
    gemm_store(g, m, n, v, t);
  }
}

template <int MT, int NT, bool VEC>
cudaError_t launch_gemm_s8_tile(const GemmArgs& g, cudaStream_t stream) {
  constexpr size_t smem = gemm_smem_bytes<MT, NT>();  // int32 as float32
  if (smem > 48 * 1024) {  // above the default limit: asked for once
    static cudaError_t attr = cudaFuncSetAttribute(
        skinny_gemm_s8_kernel<MT, NT, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid((g.N + 8 * NT - 1) / (8 * NT), (g.M + 16 * MT - 1) / (16 * MT));
  return launch_pdl(skinny_gemm_s8_kernel<MT, NT, VEC>, grid,
                    dim3(GEMM_THREADS), smem, stream, g);
}

template <int NT, bool VEC>
cudaError_t launch_gemm_s8_rows(const GemmArgs& g, cudaStream_t stream) {
  const int mt = (g.M + 15) / 16;
  switch (mt < GEMM_MAX_MT ? mt : GEMM_MAX_MT) {
    case 1: return launch_gemm_s8_tile<1, NT, VEC>(g, stream);
    case 2: return launch_gemm_s8_tile<2, NT, VEC>(g, stream);
    case 3: return launch_gemm_s8_tile<3, NT, VEC>(g, stream);
    default: return launch_gemm_s8_tile<4, NT, VEC>(g, stream);
  }
}

cudaError_t launch_gemm_s8(const GemmArgs& g, cudaStream_t stream) {
  if (g.groups < 1 || GEMM_WARPS % g.groups != 0 || g.K % g.groups != 0)
    return cudaErrorInvalidValue;
  const bool wide = (g.N + 31) / 32 >= GEMM_WIDE_BLOCKS;
  const bool vec = (g.K / g.groups) % 16 == 0 && aligned16(g.aq) &&
                   aligned16(g.wq);
  if (wide) {
    return vec ? launch_gemm_s8_rows<4, true>(g, stream)
               : launch_gemm_s8_rows<4, false>(g, stream);
  }
  return vec ? launch_gemm_s8_rows<2, true>(g, stream)
             : launch_gemm_s8_rows<2, false>(g, stream);
}

// ---- decode attention --------------------------------------------------------
// One block per (head, row). Row j of K and V for this block's rollout row
// and head starts at base + j * stride_j + b * stride_b + h * hd. The rows
// are split over the warps in groups of ATT_JB; every warp keeps an online
// softmax (running max, sum, float32 accumulator over its lanes' slices of
// the head dim: 8 elements a lane and 256-wide chunk) and the warps' states
// are merged in shared memory.

struct AttArgs {
  const bf16* q;  // [M, D], scaled
  const bf16* k;
  const bf16* v;
  bf16* out;      // [M, D]
  long long stride_j, stride_b;
  int count;      // rows when t == null
  const int* t;   // else rows = t + 1
  int L, D, hd;
};

template <bool VEC, int ATT_CHUNKS>
__global__ void __launch_bounds__(32 * ATT_WARPS)
attention_kernel(const AttArgs a) {
  // K/V rows a warp takes per iteration, all held in registers at once
  constexpr int ATT_JB = ATT_CHUNKS <= 2 ? 4 : 2;
  extern __shared__ float att_smem[];  // [ATT_WARPS] m, [ATT_WARPS] s, acc
  float* sm_m = att_smem;
  float* sm_s = att_smem + ATT_WARPS;
  float* sm_acc = att_smem + 2 * ATT_WARPS;  // [ATT_WARPS][hd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y, hd = a.hd;
  const int n = a.t ? clamp_step(a.t, a.L) + 1 : a.count;
  const bf16* qrow = a.q + (size_t)b * a.D + (size_t)h * hd;
  const bf16* kb = a.k + (long long)b * a.stride_b + (long long)h * hd;
  const bf16* vb = a.v + (long long)b * a.stride_b + (long long)h * hd;

  // before the wait: the cross-attention's hoisted slot K/V (constant over
  // the rollout); the self-attention's cache row t is the kernel before's
  if (VEC && a.t == nullptr && (int)threadIdx.x < 2 * n) {
    const int j = threadIdx.x >> 1;
    prefetch_l2_bulk(((threadIdx.x & 1) ? vb : kb) + (long long)j * a.stride_j,
                     (uint32_t)hd * 2u);
  }
  pdl_wait();
  pdl_trigger();

  float qf[ATT_CHUNKS][8], acc[ATT_CHUNKS][8];
#pragma unroll
  for (int c = 0; c < ATT_CHUNKS; ++c) {
    unpack8(load8<VEC>(qrow, c * 256 + lane * 8, hd, true), qf[c]);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[c][i] = 0.f;
  }
  float m_run = -INFINITY, s_run = 0.f;

  for (int j0 = warp * ATT_JB; j0 < n; j0 += ATT_WARPS * ATT_JB) {
    // the group's K and V rows are all asked for before any is used
    Vec8 kv[ATT_JB][ATT_CHUNKS], vv[ATT_JB][ATT_CHUNKS];
#pragma unroll
    for (int i = 0; i < ATT_JB; ++i) {
      const long long off = (long long)(j0 + i) * a.stride_j;
#pragma unroll
      for (int c = 0; c < ATT_CHUNKS; ++c) {
        const int e = c * 256 + lane * 8;
        kv[i][c] = load8<VEC>(kb + off, e, hd, j0 + i < n);
        vv[i][c] = load8<VEC>(vb + off, e, hd, j0 + i < n);
      }
    }
    float lg[ATT_JB];
#pragma unroll
    for (int i = 0; i < ATT_JB; ++i) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < ATT_CHUNKS; ++c) {
        float kf[8];
        unpack8(kv[i][c], kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) d += kf[e] * qf[c][e];
      }
      lg[i] = d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < ATT_JB; ++i)
        lg[i] += __shfl_xor_sync(0xffffffffu, lg[i], off);
    float m_new = m_run;
#pragma unroll
    for (int i = 0; i < ATT_JB; ++i)
      if (j0 + i < n) m_new = fmaxf(m_new, lg[i]);
    const float alpha = m_run == -INFINITY ? 0.f : expf(m_run - m_new);
    float p[ATT_JB], psum = 0.f;
#pragma unroll
    for (int i = 0; i < ATT_JB; ++i) {
      p[i] = j0 + i < n ? expf(lg[i] - m_new) : 0.f;
      psum += p[i];
    }
    s_run = s_run * alpha + psum;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < ATT_CHUNKS; ++c) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[c][e] *= alpha;
#pragma unroll
      for (int i = 0; i < ATT_JB; ++i) {
        float vf[8];
        unpack8(vv[i][c], vf);  // zeros for a row at or past n
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[c][e] += p[i] * vf[e];
      }
    }
  }

  if (lane == 0) {
    sm_m[warp] = m_run;
    sm_s[warp] = s_run;
  }
#pragma unroll
  for (int c = 0; c < ATT_CHUNKS; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = c * 256 + lane * 8 + e;
      if (i < hd) sm_acc[warp * hd + i] = acc[c][e];
    }
  __syncthreads();

  // warp 0 always holds row 0, so the merged max is finite
  float m_all = sm_m[0];
  for (int w = 1; w < ATT_WARPS; ++w) m_all = fmaxf(m_all, sm_m[w]);
  float wgt[ATT_WARPS], total = 0.f;
#pragma unroll
  for (int w = 0; w < ATT_WARPS; ++w) {
    wgt[w] = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - m_all);
    total += sm_s[w] * wgt[w];
  }
  for (int i = threadIdx.x; i < hd; i += 32 * ATT_WARPS) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < ATT_WARPS; ++w) v += sm_acc[w * hd + i] * wgt[w];
    a.out[(size_t)b * a.D + (size_t)h * hd + i] = __float2bfloat16_rn(v / total);
  }
}

cudaError_t launch_attention(const AttArgs& a, int rows, int heads,
                             cudaStream_t stream) {
  const size_t smem = (2 * ATT_WARPS + (size_t)ATT_WARPS * a.hd) * sizeof(float);
  const dim3 grid(heads, rows);
  // every row a multiple of 8 elements from a 16-byte boundary?
  const bool vec = a.hd % 8 == 0 && a.D % 8 == 0 && a.stride_j % 8 == 0 &&
                   a.stride_b % 8 == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v);
  const dim3 threads(32 * ATT_WARPS);
  return launch_pdl(!vec ? attention_kernel<false, ATT_MAX_CHUNKS>
                    : a.hd <= 256 ? attention_kernel<true, 1>
                    : a.hd <= 512 ? attention_kernel<true, 2>
                                  : attention_kernel<true, ATT_MAX_CHUNKS>,
                    grid, threads, smem, stream, a);
}

// ---- argmax and dictionary gather ------------------------------------------
// One block per row: each thread scans a strided slice of the logits, then
// a warp and a block reduction; among equal maxima the lowest index wins.

__device__ __forceinline__ void take_better(float& best, int& bi, float v,
                                            int i) {
  if (v > best || (v == best && i < bi)) {
    best = v;
    bi = i;
  }
}

// W8A8 (dict_q non-null): the next input is the dictionary row's codes,
// dequantized with the scales of the row's group of D vocabulary rows.
__global__ void __launch_bounds__(ROW_THREADS)
argmax_gather_kernel(const float* __restrict__ logits,
                     const bf16* __restrict__ dict,
                     const int8_t* __restrict__ dict_q,
                     const float* __restrict__ dict_s,
                     bf16* __restrict__ next_x, int* __restrict__ ids, int V,
                     int D) {
  __shared__ float sm_best[ROW_THREADS / 32];
  __shared__ int sm_idx[ROW_THREADS / 32];
  __shared__ int sm_z;
  pdl_wait();  // the logits are the kernel before's output
  pdl_trigger();
  const int m = blockIdx.x;
  const float* row = logits + (size_t)m * V;
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int n = threadIdx.x; n < V; n += ROW_THREADS) take_better(best, bi, row[n], n);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    take_better(best, bi, ov, oi);
  }
  if ((threadIdx.x & 31) == 0) {
    sm_best[threadIdx.x >> 5] = best;
    sm_idx[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < ROW_THREADS / 32; ++w) take_better(best, bi, sm_best[w], sm_idx[w]);
    sm_z = bi < V ? bi : 0;  // a row without a comparable value (all NaN)
    ids[m] = sm_z;
  }
  __syncthreads();
  const int z = sm_z;
  if (dict_q != nullptr) {
    const int8_t* code = dict_q + (size_t)z * D;
    const float* s = dict_s + (size_t)(z / D) * D;
    for (int i = threadIdx.x; i < D; i += ROW_THREADS)
      next_x[(size_t)m * D + i] = __float2bfloat16_rn(__fmul_rn(
          __fmul_rn((float)(127 * (int)code[i]), INV127), s[i]));
    return;
  }
  for (int i = threadIdx.x; i < D; i += ROW_THREADS)
    next_x[(size_t)m * D + i] = dict[(size_t)z * D + i];
}

}  // namespace

#define AR_CHECK(call)                         \
  do {                                         \
    const cudaError_t e_ = (call);             \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

// The weights of one mode: bf16 matrices, or (W8A8) int8 codes with their
// float32 scales.
struct StepWeights {
  const bf16* w;         // [nb, 14 D^2]
  const int8_t* wq;      // W8A8: [nb, 14 D^2] codes
  const float* ws;       // W8A8: [nb, 14, D] scales
  const bf16* head_w;    // [V, D]
  const int8_t* head_q;  // W8A8: [V, D] codes, head_s [V]
  const float* head_s;
  const bf16* dict_w;    // [V, D]
  const int8_t* dict_q;  // W8A8: [V, D] codes, dict_s [ceil(V / D), D]
  const float* dict_s;
};

static int decode_step(
    const void* x, const void* t, const StepWeights& W, const void* lnp,
    const void* bias, const void* ckv, void* k_cache, void* v_cache,
    const void* flnp, const void* pos, void* next_x, void* ids, void* logits,
    void* work, int B, int D, int heads, int nb, int L, int S, int V,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tp = static_cast<const int*>(t);
  const size_t bd = (size_t)B * D, dd = (size_t)D * D;
  const int hd = D / heads;
  const bool w8a8 = W.wq != nullptr;
  float* xs = static_cast<float*>(work);
  bf16* xn = reinterpret_cast<bf16*>(xs + bd);
  bf16* q = xn + bd;
  bf16* ctx = q + bd;
  bf16* hid = ctx + bd;  // [B, 4D]
  // W8A8: the codes of the current A operand [B, <= 4D] and its row scales
  // [B, <= 4], each from a 16-byte boundary after the bf16 scratch
  const size_t aq_off = (18 * bd + 15) / 16 * 16;
  int8_t* aq = static_cast<int8_t*>(work) + aq_off;
  float* as = reinterpret_cast<float*>(aq + (4 * bd + 15) / 16 * 16);
  const float* lnp_f = static_cast<const float*>(lnp);
  const float* bias_f = static_cast<const float*>(bias);
  const float* flnp_f = static_cast<const float*>(flnp);
  const bf16* ckv_b = static_cast<const bf16*>(ckv);
  int8_t* xq = w8a8 ? aq : nullptr;  // LayerNorm outputs' codes and scales
  float* xscale = w8a8 ? as : nullptr;

  for (int l = 0; l < nb; ++l) {
    const float* ln = lnp_f + (size_t)l * 6 * D;
    const float* bl = bias_f + (size_t)l * 5 * D;
    bf16* kl = static_cast<bf16*>(k_cache) + (size_t)l * L * bd;
    bf16* vl = static_cast<bf16*>(v_cache) + (size_t)l * L * bd;

    GemmArgs g = {};
    g.M = B;
    g.scale = scale;
    g.t = tp;
    g.L = L;
    g.D = D;
    // a [B, K] times the layer's matrix from JAX chunk `chunk` on (W8A8: the
    // codes and scales of a, already in aq and as, in `groups` K runs)
    auto dense = [&](const bf16* a, int chunk, int groups) {
      if (!w8a8) {
        g.a = a;
        g.w = W.w + (size_t)l * 14 * dd + (size_t)chunk * dd;
        return launch_gemm(g, st);
      }
      g.aq = aq;
      g.a_scale = as;
      g.wq = W.wq + (size_t)l * 14 * dd + (size_t)chunk * dd;
      g.w_scale = W.ws + ((size_t)l * 14 + chunk) * D;
      g.groups = groups;
      return launch_gemm_s8(g, st);
    };
    auto quantize = [&](const bf16* a, int K, int groups) {
      return w8a8 ? launch_quantize_rows(a, B, K, groups, aq, as, st)
                  : cudaSuccess;
    };

    AR_CHECK(launch_layernorm(static_cast<const bf16*>(x),
                              static_cast<const float*>(pos), tp, L, xs, ln,
                              ln + D, xn, B, D, l == 0 ? 1 : 0, xq, xscale,
                              st));

    g.N = 3 * D; g.K = D; g.epilogue = EPI_QKV;
    g.out_bf16 = q; g.k_rows = kl; g.v_rows = vl;
    AR_CHECK(dense(xn, 0, 1));

    AttArgs at = {};
    at.q = q; at.out = ctx; at.L = L; at.D = D; at.hd = hd;
    at.k = kl; at.v = vl; at.stride_j = (long long)bd; at.stride_b = D;
    at.t = tp;
    AR_CHECK(launch_attention(at, B, heads, st));

    AR_CHECK(quantize(ctx, D, 1));
    g.N = D; g.K = D; g.epilogue = EPI_RESIDUAL;
    g.out_f32 = xs; g.bias = nullptr;
    AR_CHECK(dense(ctx, 3, 1));

    AR_CHECK(launch_layernorm(nullptr, nullptr, tp, L, xs, ln + 2 * D,
                              ln + 3 * D, xn, B, D, 0, xq, xscale, st));

    g.epilogue = EPI_SCALE; g.out_bf16 = q;
    AR_CHECK(dense(xn, 4, 1));

    at.k = ckv_b + (size_t)(2 * l) * B * S * D;
    at.v = ckv_b + (size_t)(2 * l + 1) * B * S * D;
    at.stride_j = D; at.stride_b = (long long)S * D;
    at.t = nullptr; at.count = S;
    AR_CHECK(launch_attention(at, B, heads, st));

    AR_CHECK(quantize(ctx, D, 1));
    g.epilogue = EPI_RESIDUAL; g.out_f32 = xs;
    AR_CHECK(dense(ctx, 5, 1));

    AR_CHECK(launch_layernorm(nullptr, nullptr, tp, L, xs, ln + 4 * D,
                              ln + 5 * D, xn, B, D, 0, xq, xscale, st));

    g.N = 4 * D; g.K = D;
    g.epilogue = EPI_BIAS_RELU; g.bias = bl; g.out_bf16 = hid;
    AR_CHECK(dense(xn, 6, 1));

    AR_CHECK(quantize(hid, 4 * D, 4));  // fc2: one scale per D-wide group
    g.N = D; g.K = 4 * D;
    g.epilogue = EPI_RESIDUAL; g.bias = bl + 4 * D; g.out_f32 = xs;
    AR_CHECK(dense(hid, 10, 4));
  }

  AR_CHECK(launch_layernorm(nullptr, nullptr, tp, L, xs, flnp_f, flnp_f + D, xn,
                            B, D, 0, xq, xscale, st));

  GemmArgs g = {};
  g.M = B; g.N = V; g.K = D; g.epilogue = EPI_F32;
  g.out_f32 = static_cast<float*>(logits);
  if (w8a8) {
    g.aq = aq; g.a_scale = as; g.wq = W.head_q; g.w_scale = W.head_s;
    g.groups = 1;
    AR_CHECK(launch_gemm_s8(g, st));
  } else {
    g.a = xn; g.w = W.head_w;
    AR_CHECK(launch_gemm(g, st));
  }

  return (int)launch_pdl(
      argmax_gather_kernel, dim3(B), dim3(ROW_THREADS), 0, st,
      static_cast<const float*>(logits), W.dict_w, W.dict_q, W.dict_s,
      static_cast<bf16*>(next_x), static_cast<int*>(ids), V, D);
}

// One decode step for B rollout rows. Shapes as ops/ar_decode.py documents
// them; `work` holds B * D * 18 bytes of scratch; `launched` (host memory,
// two ints) receives the number of kernels the call launched and the number
// launched with the PDL attribute. Returns a cudaError_t.
extern "C" int ar_decode_step_bf16(
    const void* x, const void* t, const void* wstack, const void* lnp,
    const void* bias, const void* ckv, void* k_cache, void* v_cache,
    const void* flnp, const void* pos, const void* head_w, const void* dict_w,
    void* next_x, void* ids, void* logits, void* work, int* launched, int B,
    int D, int heads, int nb, int L, int S, int V, float scale, void* stream) {
  StepWeights W = {};
  W.w = static_cast<const bf16*>(wstack);
  W.head_w = static_cast<const bf16*>(head_w);
  W.dict_w = static_cast<const bf16*>(dict_w);
  step_launches = step_pdl_launches = 0;
  const int err = decode_step(x, t, W, lnp, bias, ckv, k_cache, v_cache, flnp,
                              pos, next_x, ids, logits, work, B, D, heads, nb,
                              L, S, V, scale, stream);
  launched[0] = step_launches;
  launched[1] = step_pdl_launches;
  return err;
}

// The W8A8 step: int8 codes and float32 scales as ops/ar_decode.py's
// PackedDecoderW8A8 holds them; `work` as ar_decode.workspace(w8a8=True)
// sizes it (the bf16 step's scratch, then the codes and row scales of an A
// operand). Otherwise as ar_decode_step_bf16.
extern "C" int ar_decode_step_w8a8(
    const void* x, const void* t, const void* wq, const void* wscale,
    const void* lnp, const void* bias, const void* ckv, void* k_cache,
    void* v_cache, const void* flnp, const void* pos, const void* head_q,
    const void* head_s, const void* dict_q, const void* dict_s, void* next_x,
    void* ids, void* logits, void* work, int* launched, int B, int D,
    int heads, int nb, int L, int S, int V, float scale, void* stream) {
  StepWeights W = {};
  W.wq = static_cast<const int8_t*>(wq);
  W.ws = static_cast<const float*>(wscale);
  W.head_q = static_cast<const int8_t*>(head_q);
  W.head_s = static_cast<const float*>(head_s);
  W.dict_q = static_cast<const int8_t*>(dict_q);
  W.dict_s = static_cast<const float*>(dict_s);
  step_launches = step_pdl_launches = 0;
  const int err = decode_step(x, t, W, lnp, bias, ckv, k_cache, v_cache, flnp,
                              pos, next_x, ids, logits, work, B, D, heads, nb,
                              L, S, V, scale, stream);
  launched[0] = step_launches;
  launched[1] = step_pdl_launches;
  return err;
}
