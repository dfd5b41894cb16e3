// Fused trajectory-attention core for Hopper (sm_90a), non-CLS tokens.
//
// Replaces three TPU kernels of focus_tpu/ops/pallas/trajectory_block.py:
// _fused_kernel_v4 (called through _fused_fwd_pallas_v4 /
// fused_trajectory_core, the default FWD_VERSION = 4) and, in the rounding
// mode V3, _fused_kernel_v3 and _fused_kernel_v7 (FWD_VERSION = 3 and 7).
// One function, three launches:
//
//   stage 1 (space_stage_core.cuh, shared with the space stage): for every
//     frame f and head, a true max-subtracted softmax of q . k_f^T * scale
//     over that frame's N keys, then P . v_f, written as xs[b, s, f, head]
//     in bf16; a persistent grid of one block an SM, a TMA producer
//     warpgroup and two ping-pong wgmma consumer warpgroups, TMA output
//     stores; past 256 keys a frame (N <= 512) its chunked form, the same
//     kernel in both roundings below.
//   stage 2a (a tiled GEMM, trajectory_core.cuh): q2 = x_diag . Wq2 + bq2,
//     where the own-frame row x_diag = xs[b, s, s / N] is gathered as the
//     tiles are copied in.
//   stage 2b (traj_stage2_kernel below, one block per 48 or 64 rows and
//     every head): per head g_h = q2_h . Wk2[:, h]^T, logits g_h . xs[f]
//     over all C channels times scale, a softmax over the F frames, and
//     sum_f a2[f] xs[f, h]. The k2 bias is constant over frames and drops
//     out of that softmax.
//
// Rounding points follow the plain version at bf16 (ops/attention.py):
// stage-1 weights, xs, q2, g and the stage-2 weights are rounded to bf16;
// every product accumulates in float32 on the tensor cores.
//
// Versions 3 and 7 compute the same function, rounded where the TPU's v3
// and v7 kernels round it (trajectory_core_v3_reference in
// ops/trajectory_block.py; the two TPU kernels are bit-equal in bf16 and
// differ in arrangement alone: v7 transposes the logits so that keys sit on
// the TPU's sublanes and sums the weights with a masked MXU product, which
// on this card costs a P^T round trip through shared memory and extra
// products). So on this card one design serves both, this one, with V3:
//   stage 1: the weights rounded before they are normalised, xs =
//     round((round(p) . V) * (1 / s)) with s the float32 sum of the
//     unrounded p (space_stage_core.cuh);
//   stage 2a: the GEMM also writes the stage-2 query round((x_diag . Wq2 +
//     bq2) * scale) into out, which stage 2b reads back for the block's rows
//     before it writes them; q2 stays unscaled, as the backward reads it;
//   stage 2b: g kept in float32 (the TPU kernels' fouter form) as a bf16
//     pair, hi = round(g) and lo = round(g - hi) (|g - hi - lo| <= 2^-16
//     |g|), each chunk's logits two m16n8k16 products instead of one, no
//     logit scale after (the query carries it), and the stage-2 weights a2
//     left in float32.
//
// Bound on this card: ~92 GFLOP per call at the flagship shape (B = 8,
// S = 1568, 12 heads) against ~60 MB of inputs and outputs, 0.093 ms, so it
// is bound by operations. The catch for a design is that stage-2 logits for
// one head contract against all C channels of xs, so every head's stage 2
// needs every head's stage 1: xs [B, S, F, C] (154 MB at B = 8) goes
// through device memory between the launches, written once by stage 1 and
// read by stage 2 once for the logits of all heads and once for the
// weighted sum (the byte floor of this form, ~0.17 ms with q, kf, vf, q2
// and out).
//
// Stage 2b's design: a block owns 64 rows (48 where that fills the last
// wave of blocks better) and all heads, so a row block's xs is read once
// for the logits. One thread keeps a ring of three 16-channel chunks in
// flight by TMA on mbarriers: each chunk is Wk2's 16 rows of every head
// ([16][64] boxes in the 128-byte swizzled layout) and the block's xs at
// those channels ([rows][8 frames][16] in the 32-byte swizzled layout, so
// the 8 frame lines an ldmatrix reads hit distinct banks; frames past F
// and rows past M read as zero). For each chunk, warp h forms g_h for all
// the block's rows on the tensor cores (mma.sync, its q2 fragments held in
// registers for the whole call, each Wk2 fragment serving two 16-row
// tiles), rounds it to bf16 and parks it in one of two g buffers
// [row][head][channel]; after one block barrier each warp takes its rows
// and, per row, adds the chunk's logits with one m16n8k16 product: the
// row's g [16 heads (padding zero) x 16 channels] times its xs [16 channels
// x 8 frames], accumulated in registers over the chunks. That barrier also
// frees the slot and g buffer of the chunk before, which the next copy and
// the next chunk's g take. After the last chunk the softmax over frames
// runs on those registers, the weights go to shared memory, and the block
// reads its rows' xs once more for the weighted sum, 16 bytes a thread, one
// head's 64 channels at a time from the last head to the first: the chunks
// read last are the likeliest still in L2.
//
// In the mode V3 a (row, head) line of a g buffer holds the chunk's 16 hi
// values, then its 16 lo values, then 8 of padding (80 bytes: the 8 lines
// an ldmatrix reads still hit distinct banks), so the two g buffers take
// 5/3 of the bytes. At 12 heads and 64 rows the ring has two slots (208
// KB) and at 48 rows three (205 KB); from 14 heads on only 48 rows leave
// two. The rows follow s2_rows_v3: 48 at B = 8, N = 196 (two waves either
// way), 64 at N = 200 (48 would take a third wave).

#include "trajectory_core.cuh"
#include "space_stage_core.cuh"

namespace {

// ---- stage 2b: stage-2 logits of all heads, F-softmax and the weighted sum

constexpr int S2_ROWS = 64;                                // rows a block, at most
constexpr int S2_MIN_ROWS = 48;                            // or 48 (see s2_rows)
constexpr int S2_WARPS = MAX_HEADS;                        // g: one head a warp
constexpr int S2_THREADS = 32 * S2_WARPS;
constexpr int S2_MAX_LROWS = S2_ROWS / S2_WARPS;           // logits: rows a warp
constexpr int S2_CH = 16;                                  // channels a chunk
constexpr int S2_MAX_STAGES = 3;                           // chunks in flight
constexpr int S2_SMEM_LIMIT = 232448;
constexpr int S2_ALIGN = 1024;                             // the swizzle atoms
// a chunk's Wk2 rows of one head, [16 channels][64] bf16 in the 128-byte
// swizzled layout, and its xs, [64 rows][8 frames][16 channels] bf16 in the
// 32-byte swizzled layout (frames past F and rows past M read as zero)
constexpr int S2_WK_HEAD_BYTES = S2_CH * HD * 2;
constexpr int S2_XS_ROW_BYTES = MAX_F * S2_CH * 2;
// bf16 length of a (row, head) line of g: 48 bytes, so the 8 lines an
// ldmatrix reads hit distinct banks; in the mode V3 the chunk's hi values,
// its lo values and the padding, 80 bytes, as conflict-free
constexpr int S2_LINE = S2_CH + 8;
constexpr int S2_LINE_V3 = 2 * S2_CH + 8;
constexpr int S2_ZERO_BYTES = 16;                          // g of padding heads
constexpr int S2_BAR_BYTES = 64;

__host__ __device__ inline int s2_stage_bytes(int heads, int rows) {
  return heads * S2_WK_HEAD_BYTES + rows * S2_XS_ROW_BYTES;
}

template <bool V3>
__host__ __device__ constexpr int s2_line() {
  return V3 ? S2_LINE_V3 : S2_LINE;
}

// bf16 stride of a row of g: 4 (mod 8) words, so the 8 rows a warp writes
// at once hit distinct banks
template <bool V3>
__host__ __device__ inline int s2_g_ld(int heads) {
  return heads * s2_line<V3>() + ((heads & 1) ? 0 : 8);
}

template <bool V3>
__host__ __device__ inline int s2_g_bytes(int heads, int rows) {
  return (rows * s2_g_ld<V3>(heads) * 2 + 15) / 16 * 16;
}

template <bool V3>
__host__ __device__ inline int s2_fixed_bytes(int heads, int rows) {
  return S2_ALIGN + 2 * s2_g_bytes<V3>(heads, rows) + S2_ZERO_BYTES +
         S2_BAR_BYTES;
}

// chunks in flight: three where they fit (12 heads), else two (16 heads;
// V3 at 12 heads and 64 rows)
template <bool V3>
__host__ __device__ inline int s2_stages(int heads, int rows) {
  const int fit = (S2_SMEM_LIMIT - s2_fixed_bytes<V3>(heads, rows)) /
                  s2_stage_bytes(heads, rows);
  return fit < S2_MAX_STAGES ? fit : S2_MAX_STAGES;
}

template <bool V3>
__host__ __device__ inline int s2_smem(int heads, int rows) {
  return s2_fixed_bytes<V3>(heads, rows) +
         s2_stages<V3>(heads, rows) * s2_stage_bytes(heads, rows);
}

// rows a block: 64, or 48 where that takes fewer waves x rows on `sms`
// SMs (one block an SM): M = 12544 (B = 8, N = 196) is 196 blocks of 64 in
// two waves, or 262 of 48 in two; M = 12800 (N = 200) 200 of 64 in two,
// or 267 of 48 in three
__host__ __device__ inline int s2_rows(int M, int sms) {
  const int w64 = ((M + 63) / 64 + sms - 1) / sms;
  const int w48 = ((M + 47) / 48 + sms - 1) / sms;
  return w48 * 48 < w64 * 64 ? S2_MIN_ROWS : S2_ROWS;
}

// the mode V3's rows: as s2_rows, but 48 where 64 rows would leave fewer
// than two chunks in flight (14 heads and more)
__host__ __device__ inline int s2_rows_v3(int M, int sms, int heads) {
  return s2_stages<true>(heads, S2_ROWS) < 2 ? S2_MIN_ROWS : s2_rows(M, sms);
}

// V3: g's bf16 hi part at p and its lo part, round(g - hi), S2_CH further
__device__ __forceinline__ void store_hi_lo(bf16* p, float a, float b) {
  const uint32_t hi = pack_bf16x2(a, b);
  const float2 h = unpack_bf16x2(hi);
  *reinterpret_cast<uint32_t*>(p) = hi;
  *reinterpret_cast<uint32_t*>(p + S2_CH) = pack_bf16x2(a - h.x, b - h.y);
}

// query: q2 [M, C], or (V3) the scaled stage-2 query that the GEMM parked
// in out, read for the block's rows before the block writes them
template <bool V3>
__global__ void __launch_bounds__(S2_THREADS, 1) traj_stage2_kernel(
    const __grid_constant__ CUtensorMap wk_map,
    const __grid_constant__ CUtensorMap xs_map, const bf16* __restrict__ xs,
    const bf16* query, bf16* out, int M, int F, int C, int heads, int rows,
    float scale) {
  constexpr int LINE = s2_line<V3>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((S2_ALIGN - (cvta_smem(smem_raw) & (S2_ALIGN - 1))) &
                  (S2_ALIGN - 1));
  const int stages = s2_stages<V3>(heads, rows);
  const int stage_bytes = s2_stage_bytes(heads, rows);
  const int mtiles = rows / 16, lrows = rows / S2_WARPS;
  const int GLD = s2_g_ld<V3>(heads);
  unsigned char* ring = smem;  // slot s: Wk2 of every head, then xs
  bf16* G = reinterpret_cast<bf16*>(ring + stages * stage_bytes);  // [2]
  bf16* zero_line = G + s2_g_bytes<V3>(heads, rows);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(zero_line) + S2_ZERO_BYTES);

  const int m0 = blockIdx.x * rows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const bool g_warp = warp < heads;  // this warp forms g of head `warp`
  const int nch = C / S2_CH;
  if (tid < S2_ZERO_BYTES / 4) reinterpret_cast<uint32_t*>(zero_line)[tid] = 0u;
  // one thread feeds the ring: chunk ci (Wk2 rows cc .. cc + 15 of every
  // head and the block's xs at those channels) into slot ci % stages
  auto issue = [&](int ci) {
    const int s = ci % stages, cc = ci * S2_CH;
    unsigned char* slot = ring + s * stage_bytes;
    mbar_arrive_expect_tx(&full[s], stage_bytes);
    for (int h = 0; h < heads; ++h)
      tma_load_2d(slot + h * S2_WK_HEAD_BYTES, &wk_map, &full[s], h * HD, cc);
    tma_load_3d(slot + heads * S2_WK_HEAD_BYTES, &xs_map, &full[s], cc, 0, m0);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int ci = 0; ci < stages - 1 && ci < nch; ++ci) issue(ci);
  }

  // query A fragments of head `warp` for the block's rows 16 mt + g and
  // + 8 (V3: plain loads, out is written later in this launch)
  auto ld = [](const bf16* p) {
    return V3 ? *reinterpret_cast<const uint32_t*>(p) : ldg32(p);
  };
  uint32_t a[S2_ROWS / 16][HD / 16][4];
#pragma unroll
  for (int mt = 0; mt < S2_ROWS / 16; ++mt) {
    const int r0 = m0 + mt * 16 + g, r1 = r0 + 8;
    const bool live = g_warp && mt < mtiles;
    const bool ok0 = live && r0 < M, ok1 = live && r1 < M;
    const bf16* p0 = query + (size_t)(ok0 ? r0 : 0) * C + warp * HD + 2 * t;
    const bf16* p1 = query + (size_t)(ok1 ? r1 : 0) * C + warp * HD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      a[mt][kk][0] = ok0 ? ld(p0 + kk * 16) : 0u;
      a[mt][kk][1] = ok1 ? ld(p1 + kk * 16) : 0u;
      a[mt][kk][2] = ok0 ? ld(p0 + kk * 16 + 8) : 0u;
      a[mt][kk][3] = ok1 ? ld(p1 + kk * 16 + 8) : 0u;
    }
  }
  __syncthreads();  // the barriers are initialised

  // logits of this warp's rows lrows warp + q: element e of lacc[q] is
  // head g + 8 (e >> 1), frame 2 t + (e & 1)
  float lacc[S2_MAX_LROWS][4];
#pragma unroll
  for (int q = 0; q < S2_MAX_LROWS; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) lacc[q][e] = 0.0f;

  int s = 0;
  uint32_t phase = 0;
  for (int ci = 0; ci < nch; ++ci) {
    mbar_wait(&full[s], phase);
    const unsigned char* slot = ring + s * stage_bytes;
    const unsigned char* xc = slot + heads * S2_WK_HEAD_BYTES;
    bf16* Gb = G + (ci & 1) * (s2_g_bytes<V3>(heads, rows) / 2);

    // g[r, h, c] = round(q2_h . Wk2[cc + c, h]^T) of head h = warp for the
    // block's 64 rows, two row tiles at a time, into Gb [row][head][channel]
    // (V3: its hi and lo parts)
    if (g_warp) {
      const unsigned char* wk = slot + warp * S2_WK_HEAD_BYTES;
      const int c = (lane & 7) + 8 * (lane >> 4);  // this lane's Wk2 row
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (2 * half >= mtiles) break;
        float acc[2][2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t kb[4];
          const int j = 2 * kk + ((lane >> 3) & 1);  // 16-byte piece of the row
          ldmatrix_x4(kb, reinterpret_cast<const bf16*>(
                              wk + c * 128 + ((j ^ (c & 7)) << 4)));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (2 * half + i >= mtiles) break;
            mma_16816(acc[i][0], a[2 * half + i][kk], kb[0], kb[1]);
            mma_16816(acc[i][1], a[2 * half + i][kk], kb[2], kb[3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (2 * half + i >= mtiles) break;
          bf16* g0 = Gb + ((2 * half + i) * 16 + g) * GLD + warp * LINE + 2 * t;
          bf16* g1 = g0 + 8 * GLD;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if constexpr (V3) {
              store_hi_lo(g0 + 8 * j, acc[i][j][0], acc[i][j][1]);
              store_hi_lo(g1 + 8 * j, acc[i][j][2], acc[i][j][3]);
            } else {
              *reinterpret_cast<uint32_t*>(g0 + 8 * j) =
                  pack_bf16x2(acc[i][j][0], acc[i][j][1]);
              *reinterpret_cast<uint32_t*>(g1 + 8 * j) =
                  pack_bf16x2(acc[i][j][2], acc[i][j][3]);
            }
          }
        }
      }
    }
    // every head's g of the chunk is in Gb; every warp is past chunk ci - 1,
    // whose slot the next chunk's copy takes and whose g buffer the next
    // chunk's g overwrites
    __syncthreads();
    if (tid == 0 && ci + stages - 1 < nch) issue(ci + stages - 1);

    // per row: logits[h, f] += g[r, h, :] . xs[r, f, :] over the chunk, one
    // m16n8k16 (A: 16 heads x 16 channels, B: 16 channels x 8 frames; V3:
    // one for hi, then one for lo); xs line (row, frame) R holds its two
    // 16-byte halves swapped where bit 2 of R (of the frame) is set
#pragma unroll
    for (int rp = 0; rp < S2_MAX_LROWS; rp += 2) {
      if (rp >= lrows) break;
      const int r = warp * lrows + rp;
      const int f = lane & 7, half = (lane >> 3) & 1;
      const int rx = rp + 1 < lrows ? r + (lane >> 4) : r;
      uint32_t xb[4];  // rows r (0, 1) and r + 1 (2, 3)
      ldmatrix_x4(xb, reinterpret_cast<const bf16*>(
                          xc + (rx * MAX_F + f) * 32 +
                          ((half ^ (f >> 2)) << 4)));
      const int h = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (rp + q >= lrows) break;
        uint32_t ga[4];
        const bf16* gl = Gb + (r + q) * GLD + h * LINE + 8 * (lane >> 4);
        ldmatrix_x4(ga, h < heads ? gl : zero_line);
        mma_16816(lacc[rp + q], ga, xb[2 * q], xb[2 * q + 1]);
        if constexpr (V3) {
          ldmatrix_x4(ga, h < heads ? gl + S2_CH : zero_line);
          mma_16816(lacc[rp + q], ga, xb[2 * q], xb[2 * q + 1]);
        }
      }
    }
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
  __syncthreads();  // every chunk is consumed: the ring holds a2 from here

  // softmax over frames (a row and head's frames lie on the quad's 4 lanes,
  // two each) -> bf16-rounded weights a2 [row][head][frame] in shared memory
  // (V3: float32; its scale is 1, the query carries the scale)
  float* A2 = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int q = 0; q < S2_MAX_LROWS; ++q) {
    if (q >= lrows) break;
    const int r = warp * lrows + q;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int h = g + 8 * hh, f0 = 2 * t, f1 = f0 + 1;
      const float l0 = f0 < F ? lacc[q][2 * hh] * scale : -INFINITY;
      const float l1 = f1 < F ? lacc[q][2 * hh + 1] * scale : -INFINITY;
      float mx = fmaxf(l0, l1);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float e0 = f0 < F ? expf(l0 - mx) : 0.0f;
      const float e1 = f1 < F ? expf(l1 - mx) : 0.0f;
      float sum = e0 + e1;
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (h < heads) {
        float* a2 = A2 + (r * MAX_HEADS + h) * MAX_F;
        a2[f0] = V3 ? e0 / sum : round_bf16(e0 / sum);
        a2[f1] = V3 ? e1 / sum : round_bf16(e1 / sum);
      }
    }
  }
  __syncthreads();

  // out[m, c] = sum_f a2[m, head(c), f] xs[m, f, c]: 64 rows x 8 pieces of
  // 8 channels, one head's 64 channels at a time, the last head first
  const int r = tid >> 3, c8 = (tid & 7) * 8, m = m0 + r;
  if (r >= rows || m >= M) return;
  for (int h = heads - 1; h >= 0; --h) {
    const float* a2 = A2 + (r * MAX_HEADS + h) * MAX_F;
    const bf16* xp = xs + (size_t)m * F * C + h * HD + c8;
    uint4 raw[MAX_F];
#pragma unroll
    for (int f = 0; f < MAX_F; ++f)
      if (f < F) raw[f] = *reinterpret_cast<const uint4*>(xp + (size_t)f * C);
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = 0.0f;
#pragma unroll
    for (int f = 0; f < MAX_F; ++f) {
      if (f >= F) break;
      const bf16* xv = reinterpret_cast<const bf16*>(&raw[f]);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = fmaf(a2[f], __bfloat162float(xv[j]), o[j]);
    }
    uint4 packed;
    uint32_t* pv = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j) pv[j] = pack_bf16x2(o[2 * j], o[2 * j + 1]);
    *reinterpret_cast<uint4*>(out + (size_t)m * C + h * HD + c8) = packed;
  }
}

// the three launches on ``st``, each counted in *launched, for the S / N
// query frames from frame f0 (all F at f0 = 0, S = F N); N <= SS_MAX_KEYS
// in both roundings. Past SS_MAX_NP stage 1 is the chunked form in both
// (launch_space_stage_chunked), whose weights are rounded unnormalised as
// the mode V3 rounds them, so the mode V3 runs kernel 1's stage 1 there and
// its xs is kernel 1's; its GEMM (the scaled second output) and stage 2
// stay its own
template <bool V3>
int traj_core_run(const void* q, const void* kf, const void* vf,
                  const void* wq2, const void* bq2, const void* wk2, void* xs,
                  void* q2, void* out, int* launched, int B, int S, int F,
                  int N, int C, int heads, float scale, cudaStream_t st,
                  int f0 = 0) {
  *launched = 0;
  if (B <= 0 || N <= 0 || N > SS_MAX_KEYS || F <= 0 || F > MAX_F || S <= 0 ||
      S % N != 0 || f0 < 0 || f0 + S / N > F ||
      heads <= 0 || heads > MAX_HEADS || C != heads * HD || C % GN != 0 ||
      !aligned16(q) || !aligned16(kf) || !aligned16(vf) || !aligned16(xs) ||
      !aligned16(q2) || !aligned16(out) || !aligned16(wk2))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;

  bf16* xs_ = static_cast<bf16*>(xs);
  bf16* out_ = static_cast<bf16*>(out);
  const auto* q_ = static_cast<const bf16*>(q);
  const auto* kf_ = static_cast<const bf16*>(kf);
  const auto* vf_ = static_cast<const bf16*>(vf);
  err = N > SS_MAX_NP
            ? launch_space_stage_chunked(q_, kf_, vf_, xs_, B, heads, S, F, N,
                                         scale, st)
            : launch_space_stage_keys<V3>(q_, kf_, vf_, xs_, B, heads, S, F,
                                          N, scale, st);
  if (err != cudaSuccess) return (int)err;
  ++*launched;

  const int M = B * S;
  // a window's own frame f0 + s / N: the gather's rows start f0 frames in
  err = launch_gemm(xs_ + (size_t)f0 * C, static_cast<const bf16*>(wq2),
                    static_cast<const bf16*>(bq2), static_cast<bf16*>(q2), M,
                    S, F, N, C, st, V3 ? out_ : nullptr, scale);
  if (err != cudaSuccess) return (int)err;
  ++*launched;

  static int sms = 0;  // the card's SM count, asked for once
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int rows = V3 ? s2_rows_v3(M, sms, heads) : s2_rows(M, sms);
  CUtensorMap wk_map, xs_map;
  {  // Wk2 [C, C]: a chunk's 16 rows of one head's 64 columns
    const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)C};
    const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
    const cuuint32_t box[2] = {HD, S2_CH};
    err = make_bf16_map(&wk_map, wk2, 2, dims, strides, box);
    if (err != cudaSuccess) return (int)err;
  }
  {  // xs [M, F, C]: a chunk's 16 channels of 8 frames of 64 rows
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)F, (cuuint64_t)M};
    const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)F * C * 2};
    const cuuint32_t box[3] = {S2_CH, MAX_F, (cuuint32_t)rows};
    err = make_bf16_map(&xs_map, xs_, 3, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_32B);
    if (err != cudaSuccess) return (int)err;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      traj_stage2_kernel<V3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S2_SMEM_LIMIT);
  if (attr != cudaSuccess) return (int)attr;
  // V3: the query is the scaled one in out, and the logits take no scale
  traj_stage2_kernel<V3><<<(M + rows - 1) / rows, S2_THREADS,
                           s2_smem<V3>(heads, rows), st>>>(
      wk_map, xs_map, xs_, V3 ? out_ : static_cast<const bf16*>(q2), out_, M,
      F, C, heads, rows, V3 ? 1.0f : scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

}  // namespace

// q [B, S, C]; kf, vf [B, F, N, C]; wq2, wk2 [C, C] ([in, out]); bq2 [C];
// scratch xs [B, S, F, C] and q2 [B, S, C]; out [B, S, C]; all bf16 and
// contiguous from 16-byte boundaries, with S = F * N, C = heads * 64 (a
// multiple of 128), F <= 8, N <= 512, heads <= 16. Launches the three
// stages on ``stream`` and returns the first cudaError_t met.
extern "C" int traj_core_bf16(const void* q, const void* kf, const void* vf,
                              const void* wq2, const void* bq2,
                              const void* wk2, void* xs, void* q2, void* out,
                              int B, int S, int F, int N, int C, int heads,
                              float scale, void* stream) {
  int launched = 0;
  return traj_core_run<false>(q, kf, vf, wq2, bq2, wk2, xs, q2, out,
                              &launched, B, S, F, N, C, heads, scale,
                              static_cast<cudaStream_t>(stream));
}

// Kernel 1 over a window of query frames (sequence parallelism): q [B, S,
// C] holds the queries of frames [f0, f0 + S / N), kf and vf all F frames;
// xs [B, S, F, C], q2 and out [B, S, C] are those rows'. A query's stage 1,
// stage 2 and own frame depend on its own row and f0 alone, so the rows are
// the whole launch's. S a multiple of N, f0 + S / N <= F; otherwise as
// traj_core_bf16.
extern "C" int traj_core_window_bf16(const void* q, const void* kf,
                                     const void* vf, const void* wq2,
                                     const void* bq2, const void* wk2,
                                     void* xs, void* q2, void* out, int B,
                                     int S, int F, int N, int C, int heads,
                                     int f0, float scale, void* stream) {
  int launched = 0;
  return traj_core_run<false>(q, kf, vf, wq2, bq2, wk2, xs, q2, out,
                              &launched, B, S, F, N, C, heads, scale,
                              static_cast<cudaStream_t>(stream), f0);
}

// The forward versions 3 and 7 (the rounding mode V3; one function, so one
// design): the operands as traj_core_bf16's (N <= 512; past 256 stage 1 is
// kernel 1's chunked form, whose rounding is already V3's but for chunk 0's
// weights, rounded against chunk 0's max and rescaled in float32 after the
// product), xs and q2 written as it writes them (q2 unscaled, with its
// bias), as the backward kernel reads them. The three launches are counted
// in *launched.
extern "C" int traj_core_v3_bf16(const void* q, const void* kf,
                                 const void* vf, const void* wq2,
                                 const void* bq2, const void* wk2, void* xs,
                                 void* q2, void* out, int* launched, int B,
                                 int S, int F, int N, int C, int heads,
                                 float scale, void* stream) {
  return traj_core_run<true>(q, kf, vf, wq2, bq2, wk2, xs, q2, out, launched,
                             B, S, F, N, C, heads, scale,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int traj_core_v7_bf16(const void* q, const void* kf,
                                 const void* vf, const void* wq2,
                                 const void* bq2, const void* wk2, void* xs,
                                 void* q2, void* out, int* launched, int B,
                                 int S, int F, int N, int C, int heads,
                                 float scale, void* stream) {
  return traj_core_run<true>(q, kf, vf, wq2, bq2, wk2, xs, q2, out, launched,
                             B, S, F, N, C, heads, scale,
                             static_cast<cudaStream_t>(stream));
}
