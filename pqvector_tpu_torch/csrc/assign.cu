// K1: nearest-centroid assignment, argmin_c |c|^2 - 2 x.c per row.
//
// Replaces pqvector_tpu/kernels/assign.py: pallas_assign (_assign_kernel).
// On the H100 it is the hot loop of the build: every Lloyd step on the
// training sample and the final pass over all rows.
//
// It runs on the score tile of score_tile.cuh with the data rows on the
// tile's query side: a block of 256 threads owns 128 rows of x and walks
// the centroids in chunks of 128, c_norm in the place of the rows' norms.
// The 128 x 128 sums of a chunk live in registers (an 8 centroids x 8 rows
// patch per thread, fed by 4 shared-memory loads per 64 FMAs from the
// cp.async ring); the epilogue keeps, per thread and owned row of x, a
// running (score, centroid) over the thread's 8 centroids of every chunk,
// and folds the 16 lanes that share the row once at the end with
// __shfl_xor, ordering on (score, id). A thread meets its centroids in
// ascending order and takes a new one only on a strict <, so ties keep the
// lowest centroid index, as jnp.argmin does. A block writes its 128 ids
// and nothing else: no score reaches shared or device memory, and no
// second launch merges anything. x is staged once per chunk, k / 128
// times: from L2 after the first where the resident blocks' rows fit it
// (264 blocks x 128 rows hold 17 MB of f32 x at d = 128), from device
// memory again at d = 1024 (67 MB of bf16 x). The centroids (512 KB at
// 1024 x 128) stay L2-resident. Centroids past k are masked by index; rows
// past n are zero-filled and never written.
//
// Scores are IEEE fp32: every sum adds its products in ascending dimension
// order with __fmaf_rn from zero, then __fmaf_rn(-2, sum, |c|^2), bit for
// bit what a sequential fmaf loop gives. Nothing rounds through TF32.
//
// What bounds it on the H100: the fp32 FMAs of the CUDA cores, 2 n k d
// operations against 67 TFLOP/s. At 16 words loaded per 64 FMAs the
// shared-memory pipe is as busy as the FMA pipe, so the loop runs at about
// half that peak, the rate of the library's own fp32 product on this card.
//
// K1 on bf16 rows (the resident matrix of a build under the bf16 wire) must
// give the ids of the f32 form over x.float(), bit for bit. Two kernels:
//
// The FMA form (pqv_assign_bf16, Bf16RowFmaTile): the f32 form's patch and
//   sums over the rows widened into its stages (exact), so its ids are the
//   f32 form's by construction. Rows are copied raw by 16-byte cp.async (d %
//   8 == 0) and widened once they land, else element by element; the
//   running argmin waits in shared memory between chunks (SharedArgminFold),
//   which keeps the walk within 128 registers.
//
// The screen (pqv_assign_bf16_screen, ScreenTile + Argmin2Fold): the wrapper
//   splits each f32 centroid into three bf16 pieces, hi = bf16(c), mid =
//   bf16(c - hi), lo = bf16(c - hi - mid); hi + mid + lo == c exactly for
//   |c| >= 2^-110 (3 x 8 significant bits cover 24). The tensor cores sum
//   x.hi + x.mid + x.lo: every product of two bf16 values is exact in fp32;
//   only the sums round. The epilogue keeps per row the best approximate
//   value v1 (with its id) and the second-best v2, and writes the id and a
//   flag: certified when v2 - v1 > 2 E(x). Then K1's f32 form gives the same
//   id. The proof, with u = 2^-24, u' = 2^-23, g(m, u) = m u / (1 - m u), t(c)
//   = x.c exactly and V(c) = |c|^2 - 2 t(c) (|c|^2 the f32 c_norm both forms
//   read):
//   - f32 form: its sum s_f takes d roundings, the j-th of the partial sum
//     s_j, each off by at most u |s_j|; so |s_f - t| <= u / (1 - d u) sum_j
//     |t_j| (t_j the exact partial sums), and sum_j |t_j| <= sum_i (d - i)
//     |x_i c_i| <= X_w C (Cauchy-Schwarz), where X_w >= |((d - i) x_i)_i|_2
//     (i from 0) and C >= max_c |c|_2. Its value v_f = RN(|c|^2 - 2 s_f)
//     then has |v_f - V| <= 2 g X_w C + u (CN + 2 X C + 2 g X_w C), g = u /
//     (1 - d u), X >= |x|_2, CN >= max |c|^2.
//   - screen: a stage adds its 3 x 64 exact products a (row, centroid) from
//     zero in 12 steps of 16 on the tensor cores, whose rounding is not IEEE:
//     lo's 4 steps, then mid's, then hi's. Whatever order and grouping a
//     step takes inside, count it as 17 roundings (16 additions and the
//     result's) that the running sum passes through, each off by at most u'
//     of the magnitude it rounds, truncation included (NVIDIA's tensor cores
//     truncate: Fasi, Higham, Mikaitis and Pranesh, "Numerical behavior of
//     NVIDIA tensor cores", PeerJ Comput. Sci. 7:e330, 2021, measured on V100,
//     T4 and A100). This model is assumed, not proven, for sm_90 wgmma on bf16
//     with fp32 accumulation; the proof holds as far as it does. What supports
//     it on the card: chip_smoke.py holds the screen's value of every row,
//     row by row, to the model's own bound from that row's products
//     (kernels/assign.py: screen_value_bound), on rows whose products span
//     2^24 within each k16 step (screen_edge) and on the phase-12 rows
//     (screen_held, also against alpha X + beta). A product then
//     passes through at most 68 roundings if it is hi's, 136 if mid's, 204
//     if lo's, so a stage's sum is off by at most
//     g(68, u') S_hi + g(136, u') S_mid + g(204, u') S_lo, S_p the sum of
//     |x_i p_i| over the stage, and S_p <= X |p|_2 over all stages. The
//     stages' sums are added in IEEE fp32 (g_n = g(n_st, u), n_st = ceil(d /
//     64)). So |s_s - t'| <= e_s X with e_s = (g(68, u') H + g(136, u') M +
//     g(204, u') L)(1 + g_n) + g_n (1 + g(204, u')) P, where t' = sum_i x_i
//     (hi_i + mid_i + lo_i), H, M, L >= the largest norm of each piece and P
//     >= max_c || |hi| + |mid| + |lo| ||_2; and |t' - t| <= X R, R >= max_c
//     |c - hi - mid - lo|_2 (0 unless a piece underflowed). So |v_s - V| <= 2
//     e_s X + 2 X R + u (CN + 2 X C + 2 e_s X + 2 X R).
//   - Underflow adds at most 2^-126 a product or sum of the tensor cores
//     (flushed to zero) and 2^-150 an fmaf: eta <= 4 (d + 1 + 386 n_st)
//     2^-126 in all, doubled by the -2.
//   So E(x) = alpha_w X_w + alpha X + beta bounds |v_f - v_s| for every
//   centroid, with alpha_w = 2 g C (1 + u), alpha = 4 u C + 2 (1 + u)(e_s +
//   R) and beta = 2 u CN + eta (kernels/assign.py: screen_coefficients). If
//   v2 - v1 > 2 E, every other centroid c has v_f(c) >= v_s(c) - E >= v2 - E
//   > v1 + E >= v_f(b): K1's f32 form picks b, strictly, with no tie. X and
//   X_w are summed in double from the bf16 values (exact squares) and rounded
//   up by 2^-30, E is taken 2^-20 high, and the test runs in double, so its
//   own roundings cannot turn it. A tie (v1 == v2), a NaN or an infinity
//   anywhere fails it. The wrapper gathers the rows that are not certified,
//   runs the FMA form over them and scatters their ids.
//   What bounds the screen: 3 x 2 n k d tensor operations against 989
//   TFLOP/s, and the stages' copies from L2 (x once, the pieces three
//   times a chunk); one block an SM (three 64 KB stages).
//
// K1 on f32 rows has the same two routes (kernels/assign.py: f32_route): the
// f32 form above over every row, or the screen over f32 rows
// (pqv_assign_f32_screen, ScreenTileF32 + Argmin2Fold) and the f32 form over
// the rows it leaves uncertified, gathered a bounded block at a time. The
// statement it proves is the same: certified => pqv_assign's id, strictly,
// with no tie.
//   - The rows are copied raw (f32) and split as they land into bf16 pieces
//     (split_step): x = xh + xm + xr exactly, xh = RN_bf16(x), xm =
//     RN_bf16(x - xh), each 0 where it would be under 2^-126 (no subnormal
//     row piece reaches the tensor cores), and xr = x - xh - xm (exact in
//     fp32; about 2^-18 |x|). No full-size copy of the pieces exists.
//   - A stage sums, from zero, the products of three pairs in this order
//     (screen_pair_*): xm.hi, xh.mid, xh.hi, 4 k16 steps each. t' = xh.(hi
//     + mid) + xm.hi exactly. What the pairs leave out is t - t' = xh.(c -
//     hi - mid) + xm.(c - hi) + xr.c, so |t - t'| <= X_h D_2 + X_m D_1 + X_r
//     C (Cauchy-Schwarz, row piece by row piece), X_h, X_m, X_r >= the
//     norms of the row's own pieces, D_j >= max_c |c - (the first j centroid
//     pieces)|_2.
//   - The tensor cores: the pair added j-th from the end of a stage passes
//     through at most 17 x 4 j roundings of u' (the bf16-row screen's model
//     and its assumption, above: 68 for xh.hi, 136 for xh.mid, 204 for
//     xm.hi), and over all stages its products sum to at most X_p C_q (C_q
//     >= max_c |c_q|_2, H and M). With the stages added in fp32, |s_s - t'|
//     <= X_h ((1 + g_n)(g(68, u') H + g(136, u') M) + g_n P_2) + X_m ((1 +
//     g_n) g(204, u') H + g_n P_1), P_j >= max_c || |hi| (+ |mid|) ||_2
//     bounding the magnitude of the stage sums (g_n (1 + g(204, u')) as for
//     bf16 rows).
//   - So |s_s - t| <= e(x) = X_h b_h + X_m b_m + X_r C, with b_h and b_m the
//     two brackets plus D_2 and D_1, and as for bf16 rows E(x) = alpha_w X_w
//     + alpha X + a_h X_h + a_m X_m + a_r X_r + beta, alpha_w = 2 g C (1 +
//     u), alpha = 4 u C, a_p = 2 (1 + u) b_p, a_r = 2 (1 + u) C, beta = 2 u CN
//     + eta, eta = 4 (d + 1 + 386 n_st) 2^-126 (kernels/assign.py:
//     screen_coefficients_f32). X and X_w come from the f32 values, the X_p
//     from the pieces split again in the epilogue, all summed in double and
//     rounded up by 2^-30.
//   - The rounding bounds hold only where no sum of either form overflows.
//     Every partial sum and value lies within CN + 2.1 X C, so a row is
//     certified only where also X <= x_limit = (2^127 - CN) / (2.5 C).
//   The pairs left out cost about 3 x 2^-18 X C beside K1 f32's own alpha_w
//   X_w, about d 2^-24 X C, so f32 rows leave more rows uncertified than
//   bf16 rows at small d (2.6% against 1.6% at d = 128, 15.6% against 13.4%
//   at 1024). Six pairs (adding xl.hi, xm.mid, xh.lo, with a third piece of
//   both) take the loss to 2^-26 but were slower at every d from 32 to 1024
//   on the H100 (scripts/torch_score_tile_check.py --sweep).
//   What bounds the screen over f32 rows: 3 x 2 n k d tensor operations, and
//   the copies: 4 bytes a row value a chunk (the rows of the resident blocks
//   outgrow L2 at d = 1024, so they come from device memory each chunk) and
//   the hi and mid pieces of every chunk from L2; one block an SM (three 64
//   KB stages). The split of a stage runs while the tensor cores take the
//   stage before it (walk_rows_lagged).
#include <math.h>

#include "score_tile.cuh"

namespace pqv {

template <class Tile>
struct ArgminFold {
  const float* c_norm;
  float* norms;  // shared, [2][kTR]: |c|^2 of this chunk and the next
  int k;
  float best[Tile::kPerThread];
  int best_i[Tile::kPerThread];

  __device__ __forceinline__ void begin(int r0, int slot) {
    if (threadIdx.x < kTR) {
      const int c = r0 + threadIdx.x;
      norms[slot * kTR + threadIdx.x] = c < k ? c_norm[c] : INFINITY;
    }
  }

  __device__ __forceinline__ void chunk(const Tile& t, int r0, int slot) {
    const float* cn = norms + slot * kTR;
#pragma unroll
    for (int g = 0; g < Tile::kGroups; ++g) {
#pragma unroll
      for (int l = 0; l < Tile::kRun; ++l) {
        const int r = t.row_base(g) + l;
        const int ci = r0 + r;
        const float s = cn[r];
        if (ci < k) {
#pragma unroll
          for (int jq = 0; jq < Tile::kPerThread; ++jq) {
            const float v = __fmaf_rn(-2.f, t.value(g, l, jq), s);
            if (v < best[jq]) {
              best[jq] = v;
              best_i[jq] = ci;
            }
          }
        }
      }
    }
  }

  // Join the lanes that hold a row's other centroids and write the ids.
  __device__ __forceinline__ void write(const Tile& t, int q0, int n, int* out) {
#pragma unroll
    for (int jq = 0; jq < Tile::kPerThread; ++jq) {
      float b = best[jq];
      int bi = best_i[jq];
#pragma unroll
      for (int x = 0; x < Tile::kXor; ++x) {
        const float ob = __shfl_xor_sync(kFull, b, 1 << x);
        const int oi = __shfl_xor_sync(kFull, bi, 1 << x);
        const bool take = (ob < b) | ((ob == b) & (oi < bi));
        b = take ? ob : b;
        bi = take ? oi : bi;
      }
      const int row = q0 + t.query(jq);
      if (t.row_lane() == 0 && row < n) out[row] = bi;
    }
  }
};

constexpr int kAssignStages = 3;

template <class Tile>
constexpr int assign_smem() {
  return 1024 + kAssignStages * Tile::kStageBytes + 2 * kTR * 4;
}

template <class Tile, class Operands>
__global__ void __launch_bounds__(kThreads, 2)
    assign_kernel(Operands op, const float* __restrict__ c_norm, int k,
                  int* __restrict__ out) {
  extern __shared__ char dyn[];
  char* ring = align_ring(dyn);
  Tile t;
  ArgminFold<Tile> epi;
  epi.c_norm = c_norm;
  epi.norms = reinterpret_cast<float*>(ring + kAssignStages * Tile::kStageBytes);
  epi.k = k;
#pragma unroll
  for (int jq = 0; jq < Tile::kPerThread; ++jq) {
    epi.best[jq] = INFINITY;
    epi.best_i[jq] = 0;
  }
  const int q0 = blockIdx.x * Tile::kQueries;
  walk_rows<kAssignStages>(t, op, q0, 0, k, ring, epi);
  epi.write(t, q0, op.B, out);
}

using AssignTile = FmaTile<float, 8>;
template <bool kVec>
using AssignTileBf16 = Bf16RowFmaTile<kVec, kAssignStages>;

// ArgminFold with its running (score, centroid) a row kept in shared memory
// between chunks ([kPerThread][kThreads] each), so that the walk holds 16
// registers fewer: the bf16-row FMA form's stage work then fits the 128
// registers of two blocks an SM without spilling.
template <class Tile>
struct SharedArgminFold : ArgminFold<Tile> {
  using Base = ArgminFold<Tile>;
  float* sbest;
  int* sbest_i;

  __device__ __forceinline__ void fetch_state() {
#pragma unroll
    for (int jq = 0; jq < Tile::kPerThread; ++jq) {
      Base::best[jq] = sbest[jq * kThreads + threadIdx.x];
      Base::best_i[jq] = sbest_i[jq * kThreads + threadIdx.x];
    }
  }
  __device__ __forceinline__ void chunk(const Tile& t, int r0, int slot) {
    fetch_state();
    Base::chunk(t, r0, slot);
#pragma unroll
    for (int jq = 0; jq < Tile::kPerThread; ++jq) {
      sbest[jq * kThreads + threadIdx.x] = Base::best[jq];
      sbest_i[jq * kThreads + threadIdx.x] = Base::best_i[jq];
    }
  }
  __device__ __forceinline__ void write(const Tile& t, int q0, int n, int* out) {
    fetch_state();
    Base::write(t, q0, n, out);
  }
};

template <bool kVec>
constexpr int assign_bf16_smem() {
  return assign_smem<AssignTileBf16<kVec>>() + 2 * 8 * kThreads * 4;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    assign_bf16_kernel(WideningOperands<__nv_bfloat16> op, const float* __restrict__ c_norm,
                       int k, int* __restrict__ out) {
  using Tile = AssignTileBf16<kVec>;
  extern __shared__ char dyn[];
  char* ring = align_ring(dyn);
  Tile t;
  t.ring = ring;
  SharedArgminFold<Tile> epi;
  epi.c_norm = c_norm;
  epi.norms = reinterpret_cast<float*>(ring + kAssignStages * Tile::kStageBytes);
  epi.sbest = epi.norms + 2 * kTR;
  epi.sbest_i = reinterpret_cast<int*>(epi.sbest + Tile::kPerThread * kThreads);
  epi.k = k;
#pragma unroll
  for (int jq = 0; jq < Tile::kPerThread; ++jq) {  // a thread's own slots: no barrier
    epi.sbest[jq * kThreads + threadIdx.x] = INFINITY;
    epi.sbest_i[jq * kThreads + threadIdx.x] = 0;
  }
  const int q0 = blockIdx.x * Tile::kQueries;
  walk_rows<kAssignStages>(t, op, q0, 0, k, ring, epi);
  epi.write(t, q0, op.B, out);
}

template <bool kVec>
int launch_assign_bf16(WideningOperands<__nv_bfloat16> op, const float* c_norm, int k,
                       int* out, void* stream) {
  auto kernel = assign_bf16_kernel<kVec>;
  constexpr int smem = assign_bf16_smem<kVec>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ceil_div(op.B, 128), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      op, c_norm, k, out);
  return (int)cudaGetLastError();
}

// The f32-row screen's certificate (kernels/assign.py: screen_coefficients_f32):
// E = alpha_w X_w + alpha X + a[0] X_h + a[1] X_m + a[2] X_rest + beta, X_h,
// X_m, X_rest >= the norms of the row's pieces xh, xm and of what they leave
// (xl + xr); a row is certified where the gap exceeds 2 E and X <= x_limit
// (no sum of either form can overflow).
struct CertF32 {
  double alpha_w, alpha, a[3], beta, x_limit;
};

// The screen's epilogue: per owned row, the best value with its id and the
// second-best value over every chunk (a tie makes them equal); at the end the
// lanes that share a row are joined, and the row's id is written with its
// certificate (assign.cu's header).
template <class Tile>
struct Argmin2Fold : ArgminFold<Tile> {
  using ArgminFold<Tile>::best;
  using ArgminFold<Tile>::best_i;
  using ArgminFold<Tile>::norms;
  using ArgminFold<Tile>::k;
  float second[Tile::kPerThread];

  __device__ __forceinline__ void chunk(const Tile& t, int r0, int slot) {
    const float* cn = norms + slot * kTR;
#pragma unroll
    for (int g = 0; g < Tile::kGroups; ++g) {
#pragma unroll
      for (int l = 0; l < Tile::kRun; ++l) {
        const int r = t.row_base(g) + l;
        const int ci = r0 + r;
        const float s = cn[r];
        if (ci < k) {
#pragma unroll
          for (int jq = 0; jq < Tile::kPerThread; ++jq) {
            const float v = __fmaf_rn(-2.f, t.value(g, l, jq), s);
            if (v < best[jq]) {
              second[jq] = best[jq];
              best[jq] = v;
              best_i[jq] = ci;
            } else if (v < second[jq]) {
              second[jq] = v;
            }
          }
        }
      }
    }
  }

  // The best value b with its id bi and the second-best s2 of owned row jq,
  // joined over the lanes that share the row.
  __device__ __forceinline__ void join(int jq, float& b, float& s2, int& bi) const {
    b = best[jq], s2 = second[jq];
    bi = best_i[jq];
#pragma unroll
    for (int x = 0; x < Tile::kXor; ++x) {
      const float ob = __shfl_xor_sync(kFull, b, 1 << x);
      const int oi = __shfl_xor_sync(kFull, bi, 1 << x);
      const float os = __shfl_xor_sync(kFull, s2, 1 << x);
      const bool take = (ob < b) | ((ob == b) & (oi < bi));
      s2 = fminf(fminf(s2, os), take ? b : ob);
      b = take ? ob : b;
      bi = take ? oi : bi;
    }
  }

  __device__ __forceinline__ void write(const Tile& t, const SplitOperands& op, int q0,
                                        double alpha_w, double alpha, double beta,
                                        int* out, uint8_t* flags, float* value) {
#pragma unroll
    for (int jq = 0; jq < Tile::kPerThread; ++jq) {
      float b, s2;
      int bi;
      join(jq, b, s2, bi);
      // |x|^2 and sum_i ((d - i) x_i)^2 of the row in double (exact squares),
      // a quarter of the row in each of its lanes.
      const int row = q0 + t.query(jq);
      double ss = 0.0, sw = 0.0;
      if (row < op.B) {
        const uint4* p = reinterpret_cast<const uint4*>(op.q + (size_t)row * op.d);
        for (int i = t.row_lane(); i < op.d / 8; i += 1 << Tile::kXor) {
          const uint4 v = p[i];
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const double lo = __uint_as_float(w[e] << 16);
            const double hi = __uint_as_float(w[e] & 0xffff0000u);
            const double wlo = (double)(op.d - 8 * i - 2 * e) * lo;
            const double whi = (double)(op.d - 8 * i - 2 * e - 1) * hi;
            ss = fma(lo, lo, fma(hi, hi, ss));
            sw = fma(wlo, wlo, fma(whi, whi, sw));
          }
        }
      }
#pragma unroll
      for (int x = 0; x < Tile::kXor; ++x) {
        ss += __shfl_xor_sync(kFull, ss, 1 << x);
        sw += __shfl_xor_sync(kFull, sw, 1 << x);
      }
      const double xn = sqrt(ss) * (1.0 + 0x1p-30), xw = sqrt(sw) * (1.0 + 0x1p-30);
      const double e = (alpha_w * xw + alpha * xn + beta) * (1.0 + 0x1p-20);
      const bool certified = (double)s2 - (double)b > 2.0 * e;
      if (t.row_lane() == 0 && row < op.B) {
        out[row] = bi;
        flags[row] = certified;
        if (value) value[row] = b;
      }
    }
  }
  // The same for f32 rows (CertF32): X, X_w and the norms of the row's
  // pieces xh, xm and of what they leave (split_step, as the stages split
  // them) summed in double, a quarter of the row in each of its lanes, eight
  // 16-byte loads in flight; the squares of f32 values are exact there, the
  // weighted ones off by 2^-53 each, which the round-up by 2^-30 covers.
  __device__ __forceinline__ void write(const Tile& t, const SplitOperandsF32& op, int q0,
                                        const CertF32& cf, int* out, uint8_t* flags,
                                        float* value) {
    constexpr int kLanes = 1 << Tile::kXor, kBatch = 8;
#pragma unroll
    for (int jq = 0; jq < Tile::kPerThread; ++jq) {
      float b, s2;
      int bi;
      join(jq, b, s2, bi);
      const int row = q0 + t.query(jq);
      double ss = 0.0, sw = 0.0, sp[3] = {0.0, 0.0, 0.0};
      if (row < op.B) {
        const float4* p = reinterpret_cast<const float4*>(op.q + (size_t)row * op.d);
        for (int i0 = t.row_lane(); i0 < op.d / 4; i0 += kLanes * kBatch) {
          float4 v4[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j)
            if (i0 + kLanes * j < op.d / 4) v4[j] = p[i0 + kLanes * j];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int i = i0 + kLanes * j;
            if (i >= op.d / 4) break;
            const float v[4] = {v4[j].x, v4[j].y, v4[j].z, v4[j].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float pc[3];
              pc[2] = split_step(split_step(v[e], pc[0]), pc[1]);
              const double x = v[e], w = (double)(op.d - 4 * i - e) * x;
              ss = fma(x, x, ss);
              sw = fma(w, w, sw);
#pragma unroll
              for (int q = 0; q < 3; ++q) sp[q] = fma((double)pc[q], (double)pc[q], sp[q]);
            }
          }
        }
      }
      for (int x = 0; x < Tile::kXor; ++x) {
        ss += __shfl_xor_sync(kFull, ss, 1 << x);
        sw += __shfl_xor_sync(kFull, sw, 1 << x);
#pragma unroll
        for (int j = 0; j < 3; ++j) sp[j] += __shfl_xor_sync(kFull, sp[j], 1 << x);
      }
      constexpr double up = 1.0 + 0x1p-30;
      const double xn = sqrt(ss) * up;
      double e = cf.alpha_w * (sqrt(sw) * up) + cf.alpha * xn + cf.beta;
#pragma unroll
      for (int j = 0; j < 3; ++j) e += cf.a[j] * (sqrt(sp[j]) * up);
      e *= 1.0 + 0x1p-20;
      const bool certified = (double)s2 - (double)b > 2.0 * e && xn <= cf.x_limit;
      if (t.row_lane() == 0 && row < op.B) {
        out[row] = bi;
        flags[row] = certified;
        if (value) value[row] = b;
      }
    }
  }
};

// One block an SM: three 64 KB stages, and the registers of two sums.
__global__ void __launch_bounds__(kThreads, 1)
    screen_kernel(SplitOperands op, const float* __restrict__ c_norm, double alpha_w,
                  double alpha, double beta, int* __restrict__ out,
                  uint8_t* __restrict__ flags, float* __restrict__ value) {
  extern __shared__ char dyn[];
  char* ring = align_ring(dyn);
  ScreenTile t;
  Argmin2Fold<ScreenTile> epi;
  epi.c_norm = c_norm;
  epi.norms = reinterpret_cast<float*>(ring + kAssignStages * ScreenTile::kStageBytes);
  epi.k = op.k;
#pragma unroll
  for (int jq = 0; jq < ScreenTile::kPerThread; ++jq) {
    epi.best[jq] = INFINITY;
    epi.second[jq] = INFINITY;
    epi.best_i[jq] = 0;
  }
  const int q0 = blockIdx.x * ScreenTile::kQueries;
  walk_rows<kAssignStages>(t, op, q0, 0, op.k, ring, epi);
  epi.write(t, op, q0, alpha_w, alpha, beta, out, flags, value);
}

// The screen over f32 rows: one block an SM (192 KB of ring).
__global__ void __launch_bounds__(kThreads, 1)
    screen_f32_kernel(SplitOperandsF32 op, const float* __restrict__ c_norm, CertF32 cf,
                      int* __restrict__ out, uint8_t* __restrict__ flags,
                      float* __restrict__ value) {
  using Tile = ScreenTileF32;
  extern __shared__ char dyn[];
  char* ring = align_ring(dyn);
  Tile t;
  t.ring = ring;
  Argmin2Fold<Tile> epi;
  epi.c_norm = c_norm;
  epi.norms = reinterpret_cast<float*>(ring + Tile::kStages * Tile::kStageBytes);
  epi.k = op.k;
#pragma unroll
  for (int jq = 0; jq < Tile::kPerThread; ++jq) {
    epi.best[jq] = INFINITY;
    epi.second[jq] = INFINITY;
    epi.best_i[jq] = 0;
  }
  const int q0 = blockIdx.x * Tile::kQueries;
  walk_rows_lagged<Tile::kStages>(t, op, q0, 0, op.k, ring, epi);
  epi.write(t, op, q0, cf, out, flags, value);
}

constexpr int screen_f32_smem() {
  return 1024 + ScreenTileF32::kStages * ScreenTileF32::kStageBytes + 2 * kTR * 4;
}

template <class Tile, class Operands>
int launch_assign(Operands op, const float* c_norm, int k, int* out, void* stream) {
  auto kernel = assign_kernel<Tile, Operands>;
  constexpr int smem = assign_smem<Tile>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ceil_div(op.B, Tile::kQueries), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(op, c_norm, k, out);
  return (int)cudaGetLastError();
}

}  // namespace pqv

// x [n, d] f32, c [k, d] f32, c_norm [k] f32 -> out [n] int32.
extern "C" int pqv_assign(const float* x, const float* c, const float* c_norm,
                          int n, int d, int k, int* out, void* stream) {
  using namespace pqv;
  if (n <= 0) return 0;
  if (k < 1) return (int)cudaErrorInvalidValue;
  return launch_assign<AssignTile>(TileOperands<float>{x, c, n, d}, c_norm, k, out, stream);
}

// K1's bf16-row form on the CUDA cores: x [n, d] bf16 (uint16 bits), c [k, d]
// f32, c_norm [k] f32 -> out [n] int32; the ids of pqv_assign over the rows
// widened to f32.
extern "C" int pqv_assign_bf16(const void* x, const float* c, const float* c_norm,
                               int n, int d, int k, int* out, void* stream) {
  using namespace pqv;
  if (n <= 0) return 0;
  if (k < 1) return (int)cudaErrorInvalidValue;
  const WideningOperands<__nv_bfloat16> op{static_cast<const __nv_bfloat16*>(x), c, n, d};
  if (d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_assign_bf16<true>(op, c_norm, k, out, stream);
  return launch_assign_bf16<false>(op, c_norm, k, out, stream);
}

// K1's screen: x [n, d] bf16, pieces [3, k, d] bf16 (hi, mid, lo), c_norm
// [k] f32, the certificate's alpha_w, alpha and beta -> out [n] int32, flags [n]
// uint8 (1: certified, the id is pqv_assign's over the widened rows) and,
// where value is not null, value [n] f32: the screen's value of the id. Needs
// d % 8 == 0 and 16-byte aligned x and pieces.
extern "C" int pqv_assign_bf16_screen(const void* x, const void* pieces,
                                      const float* c_norm, int n, int d, int k,
                                      double alpha_w, double alpha, double beta, int* out,
                                      unsigned char* flags, float* value, void* stream) {
  using namespace pqv;
  if (n <= 0) return 0;
  if (k < 1 || d % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(pieces)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = assign_smem<ScreenTile>();
  cudaError_t err = cudaFuncSetAttribute(
      screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const SplitOperands op{static_cast<const __nv_bfloat16*>(x),
                         static_cast<const __nv_bfloat16*>(pieces), n, d, k};
  screen_kernel<<<ceil_div(n, ScreenTile::kQueries), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(op, c_norm, alpha_w, alpha, beta, out,
                                                           flags, value);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of K1's launch, for the wrapper's own reckoning.
extern "C" int pqv_assign_smem() { return pqv::assign_smem<pqv::AssignTile>(); }

// The same for the bf16-row forms: the FMA form (screen 0) or the screen (1).
extern "C" int pqv_assign_bf16_smem(int screen) {
  return screen ? pqv::assign_smem<pqv::ScreenTile>() : pqv::assign_bf16_smem<true>();
}

// K1's screen over f32 rows: x [n, d] f32, pieces [3, k, d] bf16 (hi, mid, lo;
// the screen reads hi and mid), c_norm [k] f32, coef (host memory) the
// certificate's alpha_w, alpha, a_h, a_m, a_rest, beta and x_limit -> out [n]
// int32, flags [n] uint8 (1: certified, the id is pqv_assign's) and, where
// value is not null, value [n] f32: the screen's value of the id. Needs d % 8
// == 0 and 16-byte aligned x and pieces.
extern "C" int pqv_assign_f32_screen(const float* x, const void* pieces,
                                     const float* c_norm, int n, int d, int k,
                                     const double* coef, int* out, unsigned char* flags,
                                     float* value, void* stream) {
  using namespace pqv;
  if (n <= 0) return 0;
  if (k < 1 || d % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(pieces)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = screen_f32_smem();
  cudaError_t err = cudaFuncSetAttribute(
      screen_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const SplitOperandsF32 op{x, static_cast<const __nv_bfloat16*>(pieces), n, d, k};
  const CertF32 cf{coef[0], coef[1], {coef[2], coef[3], coef[4]}, coef[5], coef[6]};
  screen_f32_kernel<<<ceil_div(n, ScreenTileF32::kQueries), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(op, c_norm, cf, out, flags,
                                                               value);
  return (int)cudaGetLastError();
}

// The same for the f32-row screen.
extern "C" int pqv_assign_f32_screen_smem() { return pqv::screen_f32_smem(); }

// The pairs (row piece, centroid piece) the f32-row screen sums, in its order,
// into row[j], centroid[j] (room for 8 each) -> how many: the host's
// certificate (kernels/assign.py: F32_SCREEN_PAIRS) is held to them.
extern "C" int pqv_assign_f32_screen_pairs(int* row, int* centroid) {
  for (int j = 0; j < pqv::kScreenPairs; ++j) {
    row[j] = pqv::screen_pair_row(j);
    centroid[j] = pqv::screen_pair_centroid(j);
  }
  return pqv::kScreenPairs;
}
