// Patch-embed tokenizer for Hopper (sm_90a): a stride == kernel Conv3d
// computed as one implicit-im2col GEMM on wgmma.
//
// Replaces the TPU kernel focus_tpu/ops/pallas/patch_embed.py
// (_patch_kernel, called through _fwd_pallas / patch_embed_3d).
//
// out[m, n] = bias[n] + sum_k patch[m, k] * w[k, n], where row m is one
// (b, t', h', w') patch and column k = (i_t, i_h, i_w, c) walks the patch in
// the JAX kernel layout [kt, kh, kw, C]. No patch tensor is materialised:
// a run of kw * C values of a patch is contiguous in the [B, T, H, W, C]
// video. Patches are rounded to bf16, sums are float32, the output is
// bf16.
//
// Bound on this card: at the flagship shape (M = 12544, K = 1536, D = 768)
// the product is 29.6 GFLOP (0.030 ms at the bf16 peak) against ~99 MB of
// traffic with a float32 video (77 MB of it the video; 0.029 ms at the
// memory rate): the two bounds nearly meet, so the design has to stream
// the video once from device memory while the tensor cores stay busy.
//
// Design (one launch; a block owns 128 patch rows and 256 output columns,
// the three column blocks of a row block launched next to each other so
// the video they share comes from device memory once and from L2 after):
//   - a producer warpgroup fills a ring of stages of 64 K columns each: its
//     first thread copies the weight's [64 K x 256 columns] slice by TMA
//     (four 64-column boxes in the 128-byte swizzled layout, K past the end
//     read as zero), and all 128 threads gather the A tile [128 rows x 64 K]
//     straight from the video with cp.async, 16 bytes a copy where the runs
//     allow it (narrower copies for other C and kw, element copies for odd
//     bf16 runs), into a padded staging tile in the video's own type; each
//     thread's copies complete on the stage's mbarrier (cp.async's
//     mbarrier arrive), beside the TMA bytes;
//   - two consumer warpgroups own 64 rows each: per stage they read their
//     rows' A fragments from the staging tile, round them to bf16 in
//     registers (TMA cannot convert float32 to bf16) and issue four
//     m64n256k16 wgmmas with A from registers and the weight read MN-major
//     from shared memory; the next stage's fragments are read while those
//     products run; setmaxnreg gives the consumers 224 registers (128 of
//     them the accumulator) and the producer 56;
//   - the epilogue adds the bias, rounds once to bf16, stages the tile in
//     shared memory and writes it with 16-byte stores (rows past M and
//     columns past D are not written).
// The video is read as float32 or bf16; any C, kw and kernel depth, ragged
// M and any D go through this kernel (D % 8 != 0 through a weight whose
// rows the caller pads to a multiple of 8 and element stores).

#include "hopper_async.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int PE_BM = 128;             // patch rows a block
constexpr int PE_BN = 256;             // output columns a block
constexpr int PE_BK = 64;              // K a stage: a 128-byte weight row
constexpr int PE_WG = 2;               // consumer warpgroups of 64 rows
constexpr int PE_THREADS = 128 * (PE_WG + 1);
constexpr int PE_PRODUCER_REGS = 56;   // 56 + 2 x 224 = 3 x 168
constexpr int PE_CONSUMER_REGS = 224;
constexpr int PE_LDA = PE_BK + 8;      // elements of a staged A row
constexpr int PE_B_BOX = PE_BK * 128;  // bytes of a [64 K][64 columns] box
constexpr int PE_B_BYTES = (PE_BN / 64) * PE_B_BOX;
constexpr int PE_LDO = PE_BN + 8;      // bf16 stride of the output staging
constexpr int PE_OUT_BYTES = PE_WG * 64 * PE_LDO * 2;
constexpr int PE_ALIGN = 1024;         // the 128-byte swizzle atom
constexpr int PE_TAIL_BYTES = PE_BM * 8 + 256;  // row bases and mbarriers
constexpr int PE_MAX_STAGES = 4;
constexpr int PE_SMEM_LIMIT = 232448;

__host__ __device__ constexpr int pe_a_bytes(int elem) {
  return PE_BM * PE_LDA * elem;
}

__host__ __device__ constexpr int pe_stages(int elem) {
  return (PE_SMEM_LIMIT - PE_ALIGN - PE_TAIL_BYTES) /
                     (PE_B_BYTES + pe_a_bytes(elem)) < PE_MAX_STAGES
             ? (PE_SMEM_LIMIT - PE_ALIGN - PE_TAIL_BYTES) /
                   (PE_B_BYTES + pe_a_bytes(elem))
             : PE_MAX_STAGES;
}

__host__ __device__ constexpr int pe_smem_bytes(int elem) {
  return PE_ALIGN + pe_stages(elem) * (PE_B_BYTES + pe_a_bytes(elem)) +
         PE_TAIL_BYTES;
}

static_assert(pe_stages(4) >= 3 && pe_stages(2) >= 3, "a three-stage ring");
static_assert(pe_stages(4) * pe_a_bytes(4) >= PE_OUT_BYTES &&
                  pe_stages(2) * pe_a_bytes(2) >= PE_OUT_BYTES,
              "the output staging fits in the A stages");

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two neighbouring staged elements as a bf16 pair (rounded to nearest)
__device__ __forceinline__ uint32_t pair_bf16(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16x2(v.x, v.y);
}

__device__ __forceinline__ uint32_t pair_bf16(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// V elements of the video into the staging tile: cp.async of 16, 8 or 4
// bytes (zeros where !ok), or an element copy for 2 bytes
template <typename Tin, int V>
__device__ __forceinline__ void stage_copy(Tin* dst, const Tin* src, bool ok) {
  constexpr int BYTES = V * (int)sizeof(Tin);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(cvta_smem(dst)), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else if constexpr (BYTES >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(cvta_smem(dst)), "l"(src), "n"(BYTES),
                    "r"(ok ? BYTES : 0)
                 : "memory");
  } else {
    *dst = ok ? *src : Tin(0.0f);
  }
}

// this thread's cp.async copies so far complete on `bar` as one arrival
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(cvta_smem(bar)) : "memory");
}

template <typename Tin, int V>
__global__ void __launch_bounds__(PE_THREADS, 1) patch_embed_kernel(
    const __grid_constant__ CUtensorMap w_map, const Tin* __restrict__ x,
    const bf16* __restrict__ bias, bf16* __restrict__ out, int T, int H,
    int W, int C, int kt, int kh, int kw, int tp, int hp, int wp, int M,
    int K, int D) {
  constexpr int ELEM = (int)sizeof(Tin);
  constexpr int STAGES = pe_stages(ELEM);
  constexpr bool ASYNC = V * ELEM >= 4;  // copies complete by cp.async
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((PE_ALIGN - (cvta_smem(smem_raw) & (PE_ALIGN - 1))) &
                  (PE_ALIGN - 1));
  unsigned char* bst = smem;  // weight stages, 1024-aligned for the swizzle
  Tin* ast = reinterpret_cast<Tin*>(smem + STAGES * PE_B_BYTES);
  long long* row_base = reinterpret_cast<long long*>(
      smem + STAGES * (PE_B_BYTES + pe_a_bytes(ELEM)));
  uint64_t* full = reinterpret_cast<uint64_t*>(row_base + PE_BM);
  uint64_t* empty = full + PE_MAX_STAGES;

  const int n0 = blockIdx.x * PE_BN, m0 = blockIdx.y * PE_BM;
  const int nk = (K + PE_BK - 1) / PE_BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128 + 1);  // each producer thread, and the TMA
      mbar_init(&empty[s], 128 * PE_WG);
    }
    mbar_init_fence();
  }
  if (tid < PE_BM) {  // the video offset of each row's patch, -1 past M
    const int m = m0 + tid;
    long long base = -1;
    if (m < M) {
      int rest = m;
      const int wi = rest % wp; rest /= wp;
      const int hi = rest % hp; rest /= hp;
      const int ti = rest % tp;
      const int b = rest / tp;
      base = ((((long long)b * T + (long long)ti * kt) * H +
               (long long)hi * kh) * W + (long long)wi * kw) * C;
    }
    row_base[tid] = base;
  }
  __syncthreads();

  if (tid >= 128 * PE_WG) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PE_PRODUCER_REGS));
    const int pt = tid - 128 * PE_WG;
    constexpr int VPR = PE_BK / V;   // copies a staged row
    constexpr int RPP = 128 / VPR;   // rows the warpgroup covers a pass
    const int cv = pt % VPR, rsub = pt / VPR;
    const int run = kw * C;
    int stage = 0;
    uint32_t phase = 0;
    for (int ks = 0; ks < nk; ++ks) {
      mbar_wait(&empty[stage], phase ^ 1);
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[stage], PE_B_BYTES);
        for (int j = 0; j < PE_BN / 64; ++j)
          tma_load_2d(bst + stage * PE_B_BYTES + j * PE_B_BOX, &w_map,
                      &full[stage], n0 + 64 * j, ks * PE_BK);
      }
      // this thread's K columns k .. k + V - 1 lie in one run of the patch
      const int k = ks * PE_BK + cv * V;
      long long off = -1;
      if (k < K) {
        const int q = k / run, rem = k - q * run;
        off = ((long long)(q / kh) * H + (q % kh)) * W * C + rem;
      }
      Tin* dst = ast + stage * PE_BM * PE_LDA + cv * V;
#pragma unroll 4
      for (int r = rsub; r < PE_BM; r += RPP) {
        const long long base = row_base[r];
        const bool ok = base >= 0 && off >= 0;
        stage_copy<Tin, V>(dst + r * PE_LDA, ok ? x + base + off : x, ok);
      }
      if constexpr (ASYNC) cp_async_mbar_arrive(&full[stage]);
      else mbar_arrive(&full[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (ASYNC) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(PE_CONSUMER_REGS));
  // a consumer warpgroup: A rows 64 wg + 16 warp + g and + 8, as the
  // m16n8k16 A fragment of each warp's 16 rows; accumulator element 4j + e
  // is column 8j + 2 t + (e & 1), the second row for e >= 2
  const int wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ar0 = wg * 64 + warp * 16 + g;
  auto load_a = [&](int s, uint32_t (&f)[PE_BK / 16][4]) {
    const Tin* a0 = ast + s * PE_BM * PE_LDA + ar0 * PE_LDA + 2 * t;
    const Tin* a1 = a0 + 8 * PE_LDA;
#pragma unroll
    for (int kk = 0; kk < PE_BK / 16; ++kk) {
      f[kk][0] = pair_bf16(a0 + 16 * kk);
      f[kk][1] = pair_bf16(a1 + 16 * kk);
      f[kk][2] = pair_bf16(a0 + 16 * kk + 8);
      f[kk][3] = pair_bf16(a1 + 16 * kk + 8);
    }
  };
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  uint32_t fa[PE_BK / 16][4], fb[PE_BK / 16][4];
  int stage = 0;
  uint32_t phase = 0;
  // one k-step: products of stage `stage` with fragments `cur`, and the
  // next stage's fragments read into `nxt` while they run
  auto step = [&](int ks, uint32_t (&cur)[PE_BK / 16][4],
                  uint32_t (&nxt)[PE_BK / 16][4]) {
    const uint64_t db =
        wgmma_desc_sw128(bst + stage * PE_B_BYTES, PE_B_BOX, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PE_BK / 16; ++kk)
      wgmma_rs_n256_tb(acc, cur[kk], db + (uint64_t)(kk * 128), 1);
    wgmma_commit();
    int nstage = stage + 1;
    uint32_t nphase = phase;
    if (nstage == STAGES) {
      nstage = 0;
      nphase ^= 1;
    }
    if (ks + 1 < nk) {
      mbar_wait(&full[nstage], nphase);
      load_a(nstage, nxt);
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[stage]);
    stage = nstage;
    phase = nphase;
  };
  mbar_wait(&full[0], 0);
  load_a(0, fa);
  for (int ks = 0; ks < nk; ks += 2) {
    step(ks, fa, fb);
    if (ks + 1 < nk) step(ks + 1, fb, fa);
  }
  reg_fence(acc);

  // epilogue: bias, one rounding, the tile staged in the A stages (free
  // once both warpgroups are past their last stage), 16-byte stores
  named_barrier(1, 128 * PE_WG);
  bf16* ot = reinterpret_cast<bf16*>(ast) + wg * 64 * PE_LDO;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < PE_BN / 8; ++j) {
    const int col = 8 * j + 2 * t, n = n0 + col;
    const float b0 = n < D ? __bfloat162float(bias[n]) : 0.0f;
    const float b1 = n + 1 < D ? __bfloat162float(bias[n + 1]) : 0.0f;
    *reinterpret_cast<uint32_t*>(ot + r0 * PE_LDO + col) =
        pack_bf16x2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    *reinterpret_cast<uint32_t*>(ot + (r0 + 8) * PE_LDO + col) =
        pack_bf16x2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
  named_barrier(2 + wg, 128);
  const bool wide = (D & 7) == 0;
  for (int i = tid & 127; i < 64 * (PE_BN / 8); i += 128) {
    const int r = i / (PE_BN / 8), c8 = (i % (PE_BN / 8)) * 8;
    const int m = m0 + wg * 64 + r, n = n0 + c8;
    if (m >= M || n >= D) continue;
    const bf16* src = ot + r * PE_LDO + c8;
    bf16* dst = out + (size_t)m * D + n;
    if (wide) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && n + j < D; ++j) dst[j] = src[j];
    }
  }
}

template <typename Tin, int V>
cudaError_t launch_patch_embed(const Tin* x, const bf16* w, const bf16* bias,
                               bf16* out, int T, int H, int W, int C, int kt,
                               int kh, int kw, int tp, int hp, int wp, int M,
                               int K, int D, cudaStream_t st) {
  // the weight [K, Dp] with rows padded to Dp = D rounded up to 8 columns
  // (TMA strides are multiples of 16 bytes): [64 K x 64 columns] boxes
  CUtensorMap wm;
  const cuuint64_t Dp = (cuuint64_t)(D + 7) / 8 * 8;
  const cuuint64_t dims[2] = {Dp, (cuuint64_t)K};
  const cuuint64_t strides[1] = {Dp * 2};
  const cuuint32_t box[2] = {64, PE_BK};
  cudaError_t e = make_bf16_map(&wm, w, 2, dims, strides, box);
  if (e != cudaSuccess) return e;
  constexpr int smem = pe_smem_bytes((int)sizeof(Tin));
  static const cudaError_t attr = cudaFuncSetAttribute(
      patch_embed_kernel<Tin, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((D + PE_BN - 1) / PE_BN, (M + PE_BM - 1) / PE_BM);
  patch_embed_kernel<Tin, V><<<grid, PE_THREADS, smem, st>>>(
      wm, x, bias, out, T, H, W, C, kt, kh, kw, tp, hp, wp, M, K, D);
  return cudaGetLastError();
}

// the widest copy (elements) that every run of kw * C values, every video
// row of W * C values and the video's address allow, up to 16 bytes
int copy_width(const void* x, int elem, int run, int wc) {
  for (int v = 16 / elem; v > 1; v /= 2)
    if (run % v == 0 && wc % v == 0 &&
        reinterpret_cast<uintptr_t>(x) % (uintptr_t)(v * elem) == 0)
      return v;
  return 1;
}

}  // namespace

// x [B, T, H, W, C] (float32 when x_is_bf16 == 0, else bf16); w [K, Dp]
// bf16 with K = kt * kh * kw * C in [kt, kh, kw, C] order and Dp = D
// rounded up to a multiple of 8 (columns past D zero); bias [D] bf16; out
// [B, T/kt * H/kh * W/kw, D] bf16; w and out from 16-byte boundaries.
// Returns the launch's cudaError_t.
extern "C" int patch_embed_bf16(const void* x, const void* w, const void* bias,
                                void* out, int x_is_bf16, int B, int T, int H,
                                int W, int C, int kt, int kh, int kw, int D,
                                void* stream) {
  const int tp = T / kt, hp = H / kh, wp = W / kw;
  const int M = B * tp * hp * wp, K = kt * kh * kw * C;
  if (M <= 0 || D <= 0 || K <= 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* w_ = static_cast<const bf16*>(w);
  const bf16* b_ = static_cast<const bf16*>(bias);
  bf16* o_ = static_cast<bf16*>(out);
  if (x_is_bf16) {
    const bf16* x_ = static_cast<const bf16*>(x);
    switch (copy_width(x, 2, kw * C, W * C)) {
      case 8:
        return (int)launch_patch_embed<bf16, 8>(x_, w_, b_, o_, T, H, W, C, kt,
                                                kh, kw, tp, hp, wp, M, K, D, st);
      case 4:
        return (int)launch_patch_embed<bf16, 4>(x_, w_, b_, o_, T, H, W, C, kt,
                                                kh, kw, tp, hp, wp, M, K, D, st);
      case 2:
        return (int)launch_patch_embed<bf16, 2>(x_, w_, b_, o_, T, H, W, C, kt,
                                                kh, kw, tp, hp, wp, M, K, D, st);
      default:
        return (int)launch_patch_embed<bf16, 1>(x_, w_, b_, o_, T, H, W, C, kt,
                                                kh, kw, tp, hp, wp, M, K, D, st);
    }
  }
  const float* x_ = static_cast<const float*>(x);
  switch (copy_width(x, 4, kw * C, W * C)) {
    case 4:
      return (int)launch_patch_embed<float, 4>(x_, w_, b_, o_, T, H, W, C, kt,
                                               kh, kw, tp, hp, wp, M, K, D, st);
    case 2:
      return (int)launch_patch_embed<float, 2>(x_, w_, b_, o_, T, H, W, C, kt,
                                               kh, kw, tp, hp, wp, M, K, D, st);
    default:
      return (int)launch_patch_embed<float, 1>(x_, w_, b_, o_, T, H, W, C, kt,
                                               kh, kw, tp, hp, wp, M, K, D, st);
  }
}
