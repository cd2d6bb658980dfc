// K9: per-tile minimum of |x|^2 - 2 q.x over contiguous row tiles, values
// only (pass 1 of the certified-exact scan).
//
// Replaces pqvector_tpu/kernels/tilemin.py: pallas_tile_min
// (_tilemin_kernel).
//
// The TPU kernel scores a [bt, ct * tile] block on the matrix unit and folds
// each tile's lane group to its minimum before the block leaves fast
// memory. Here a block owns up to 128 queries and a run of rows and walks
// them with the score tile of score_tile.cuh: the sums of a 128-row chunk
// stay in registers and are folded there. A thread first takes the minimum
// over its own rows of a tile, then __shfl_xor joins the lanes that hold the
// tile's other rows, and for a tile longer than a chunk one shared-memory word
// per query carries the minimum from chunk to chunk. No score reaches shared
// or device memory. Tiles are independent, so no state crosses blocks: no atomics, no
// merge launch. The query groups of one run are neighbours in the grid, so
// the second group finds the rows in L2.
//
// The score is the TPU kernel's: q2 = (-2 q) rounded to the storage dtype
// by the caller, dot(q2, x) accumulated in fp32, then + |x|^2 with
// __fadd_rn. A pad row is all zeros, so its score is its norm: +3e38 or
// +inf, never NaN (0 x inf is never formed: the norm is added after the
// dot), and a tile of pad rows only returns that sentinel.
//
// What bounds it on the H100. f32 storage: the fp32 FMAs of the CUDA cores,
// 2 B n_pad d operations against 67 TFLOP/s; the f32 score must be IEEE
// fp32, so no tensor core takes it. The 8 x 8 register patch feeds 64 FMAs
// from 4 shared-memory loads, and the cp.async ring keeps the next slices
// in flight while the FMAs run. At 16 words loaded per 64 FMAs the
// shared-memory pipe (32 words a clock) is as busy as the FMA pipe (128 a
// clock), so the kernel runs at about half the FMA peak, the rate of the
// library's own fp32 product on this card; a larger patch is the way on.
// bf16 storage: bytes, 2 n_pad d against 3.35 TB/s, once the products run on
// the tensor cores (wgmma), as they do where d % 8 == 0; other widths widen
// into the fp32 patch. There the queries' slice is fetched again from L2 for
// every chunk, as many bytes as the rows themselves.
#include "score_tile.cuh"

namespace pqv {

template <class Tile>
struct MinFold {
  const float* emb_sq;
  float* out;
  float* sqs;    // shared, [2][kTR]: the norms of this chunk and the next
  float* carry;  // shared, [kQueries]: a long tile's minimum so far; only the
                 // thread with row_lane() == 0 touches its queries' slots
  int B, q0, row_end, tile, nt;

  __device__ __forceinline__ void begin(int r0, int slot) {
    if (threadIdx.x < kTR) {
      const int row = r0 + threadIdx.x;
      sqs[slot * kTR + threadIdx.x] =
          row < row_end ? emb_sq[row] : __int_as_float(0x7f800000);
    }
  }

  __device__ __forceinline__ void store(int jq, const Tile& t, int row, float v) {
    const int b = q0 + t.query(jq);
    if (b < B && row < row_end) out[(size_t)b * nt + row / tile] = v;
  }

  __device__ __forceinline__ void chunk(const Tile& t, int r0, int slot) {
    constexpr int G = Tile::kGroups, L = Tile::kRun, NQ = Tile::kPerThread;
    const float inf = __int_as_float(0x7f800000);
    const float* sq = sqs + slot * kTR;
    const int gpt = tile / Tile::kSpan;  // groups of a tile longer than a span
    float run[NQ];
#pragma unroll
    for (int jq = 0; jq < NQ; ++jq) run[jq] = inf;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[L];
#pragma unroll
      for (int l = 0; l < L; ++l) s[l] = sq[t.row_base(g) + l];
#pragma unroll
      for (int jq = 0; jq < NQ; ++jq) {
        float v[L];
#pragma unroll
        for (int l = 0; l < L; ++l) v[l] = __fadd_rn(t.value(g, l, jq), s[l]);
        if (tile < L) {  // tiles of 2 rows in a run of 4
#pragma unroll
          for (int p = 0; p < L / 2; ++p)
            store(jq, t, r0 + t.row_base(g) + 2 * p, fminf(v[2 * p], v[2 * p + 1]));
          continue;
        }
        float m = v[0];
#pragma unroll
        for (int l = 1; l < L; ++l) m = fminf(m, v[l]);
        if (tile <= Tile::kSpan) {  // the tile's other rows are in lanes
#pragma unroll
          for (int x = 0; x < Tile::kXor; ++x)
            if ((L << x) < tile) m = fminf(m, __shfl_xor_sync(kFull, m, 1 << x));
          if (t.row_lane() % (tile / L) == 0) store(jq, t, r0 + t.row_base(g), m);
          continue;
        }
        run[jq] = fminf(run[jq], m);
        const bool last = tile >= kTR ? g == G - 1 : ((g + 1) & (gpt - 1)) == 0;
        if (!last) continue;
        m = run[jq];
        run[jq] = inf;
#pragma unroll
        for (int x = 0; x < Tile::kXor; ++x)
          m = fminf(m, __shfl_xor_sync(kFull, m, 1 << x));
        if (t.row_lane() != 0) continue;
        if (tile < kTR) {
          store(jq, t, r0 + Tile::kSpan * (g + 1 - gpt), m);
        } else {  // carry across the chunks of a long tile
          m = fminf(carry[t.query(jq)], m);
          if ((r0 + kTR) % tile == 0) {
            store(jq, t, r0, m);
            m = inf;
          }
          carry[t.query(jq)] = m;
        }
      }
    }
  }
};

template <class Tile, int STAGES>
__global__ void __launch_bounds__(kThreads, 2)
    tile_min_kernel(TileOperands<typename Tile::Storage> op,
                    const float* __restrict__ emb_sq, float* __restrict__ out,
                    int n_pad, int tile, int run, int nqb) {
  extern __shared__ char dyn[];
  char* ring = align_ring(dyn);
  Tile t;
  MinFold<Tile> epi;
  epi.emb_sq = emb_sq;
  epi.out = out;
  epi.sqs = reinterpret_cast<float*>(ring + STAGES * Tile::kStageBytes);
  epi.B = op.B;
  epi.q0 = (blockIdx.x % nqb) * Tile::kQueries;
  const int row_begin = (blockIdx.x / nqb) * run;
  epi.row_end = min(row_begin + run, n_pad);
  epi.tile = tile;
  epi.nt = n_pad / tile;
  epi.carry = epi.sqs + 2 * kTR;
  if (threadIdx.x < Tile::kQueries)  // a barrier of the walk precedes its use
    epi.carry[threadIdx.x] = __int_as_float(0x7f800000);
  walk_rows<STAGES>(t, op, epi.q0, row_begin, epi.row_end, ring, epi);
}

constexpr int kMinStages = 3;

template <class Tile>
constexpr int tile_min_smem() {
  return 1024 + kMinStages * Tile::kStageBytes + (2 * kTR + 128) * 4;
}

template <class Tile>
int launch_tile_min(const void* q2, const void* emb, const float* emb_sq, float* out,
                    int B, int d, int n_pad, int tile, int run, cudaStream_t st) {
  using T = typename Tile::Storage;
  TileOperands<T> op = {static_cast<const T*>(q2), static_cast<const T*>(emb), B, d};
  auto kernel = tile_min_kernel<Tile, kMinStages>;
  constexpr int smem = tile_min_smem<Tile>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nqb = ceil_div(B, Tile::kQueries);
  kernel<<<ceil_div(n_pad, run) * nqb, kThreads, smem, st>>>(op, emb_sq, out, n_pad, tile,
                                                              run, nqb);
  return (int)cudaGetLastError();
}

}  // namespace pqv

// q2 [B, d] = (-2 q) in emb's dtype, emb [n_pad, d] (bf16 when is_bf16),
// emb_sq [n_pad] f32; out [B, n_pad / tile] f32. tile is a power of two that
// divides n_pad; run, the rows one block owns, is a multiple of
// max(tile, 128). wgmma picks the tensor-core back end: bf16, d % 8 == 0 and
// both arrays 16-byte aligned.
extern "C" int pqv_tile_min(const void* q2, const void* emb, const float* emb_sq,
                            int B, int d, int n_pad, int tile, int run,
                            int is_bf16, int wgmma, float* out, void* stream) {
  using namespace pqv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (run % kTR || run % tile) return (int)cudaErrorInvalidValue;
  if (wgmma) {
    if (!is_bf16 || d % 8 || ((uintptr_t)q2 | (uintptr_t)emb) % 16)
      return (int)cudaErrorInvalidValue;
    return launch_tile_min<MmaTile>(q2, emb, emb_sq, out, B, d, n_pad, tile, run, st);
  }
  if (is_bf16) {
    if (B > 64)
      return launch_tile_min<FmaTile<__nv_bfloat16, 8>>(q2, emb, emb_sq, out, B, d,
                                                        n_pad, tile, run, st);
    return launch_tile_min<FmaTile<__nv_bfloat16, 4>>(q2, emb, emb_sq, out, B, d, n_pad,
                                                      tile, run, st);
  }
  if (B > 64)
    return launch_tile_min<FmaTile<float, 8>>(q2, emb, emb_sq, out, B, d, n_pad, tile,
                                              run, st);
  return launch_tile_min<FmaTile<float, 4>>(q2, emb, emb_sq, out, B, d, n_pad, tile, run,
                                            st);
}

// Dynamic shared memory of K9's launch, for the wrapper's own reckoning.
extern "C" int pqv_tile_min_smem(int wgmma, int block_queries) {
  using namespace pqv;
  if (wgmma) return tile_min_smem<MmaTile>();
  return block_queries > 64 ? tile_min_smem<FmaTile<float, 8>>()
                            : tile_min_smem<FmaTile<float, 4>>();
}
