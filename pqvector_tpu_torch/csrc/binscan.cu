// K7 and K8: the fused binned-min scan, over every tile (K7) or over a list
// of selected tiles (K8), for f32, bf16 and int8 storage.
//
// Replace pqvector_tpu/kernels/binscan.py: pallas_binned_scan
// (_binscan_kernel, _binscan8_kernel) and pallas_binned_scan_select
// (_binscan_select_kernel, _binscan8_select_kernel), all on _binscan_body.
//
// Each (query, row) pair gives one int32 key: the true squared distance
// (|q|^2 - 2 q.x + |x|^2) as f32 bits with the low code_bits replaced by
// the row's provenance (g3 << tg_bits) + tg. The key is min-folded into the
// query's bin (slab, lane) of a table [expand * n_lg, B, 128], with
// slab = (t + g3) % n_lg + (tg % expand) * n_lg, so the 128-row lane groups
// of one tile land in distinct slabs. t is the tile (K7) or the slot of the
// selected tile (K8), tg = t / n_lg, g3 the lane group within the tile.
//
// The TPU carries the table through an ordered grid and initialises a bin
// at its first touch. A CUDA grid has no order, so the table starts at
// INT32_MAX and blocks fold into it with atomicMin. The minimum does not
// depend on the order, and since every bin is touched (the wrapper checks
// nt >= expand * n_lg, or cap for K8) it equals the TPU's table.
//
// Block (query group, slab, split) owns one slab of the table: for each
// slot of its slab block (tile groups with tg % expand == e) it scores the
// one lane group that folds into that slab, g3 = (slab - t) mod n_lg, so
// every (slot, lane group) pair is scored by exactly one block of a query
// group (SlabChunks; kernels/binscan.py:chunk_schedule is the same index
// math in Python). It walks those lane groups as 128-row chunks of the score
// tile (score_tile.cuh, walk_list). A lane group is a chunk, so the sum for
// (query, row r of the chunk) always folds into bin (query, lane r): the same
// accumulator position in every chunk. The block's bins are therefore an
// int array shaped like the tile's accumulator, in registers, and the
// epilogue is elementwise: key = (bits((acc + |x|^2) + |q|^2) & hi) | code,
// then min. No shared table, no shuffle, no list; one atomicMin per bin when
// the walk is done.
//
// Back ends (score_tile.cuh): bf16 with d % 8 == 0 and 16-byte aligned
// arrays on wgmma (MmaTile, 128 queries a block); f32, and bf16 of other
// widths, on the fp32 patch (FmaTile, 128 queries, 64 for a batch of at most
// 64); int8 codes on the dp4a patch (Dp4aTile, the same shapes), whose int32
// sums are exact, as the int8 MXU's are. What bounds it on the H100 (1M x
// 128, B = 256): bf16 takes 0.52 ms against 0.08 for its bytes; with 64 bins
// beside 64 sums a thread, one block fits an SM, so the key fold and the
// barriers of a chunk do not overlap the tensor cores' work. f32 takes 2.4
// ms, the fp32 FMAs of the patch at about half the 67 TFLOP/s peak (K9's
// rate); int8 1.1 ms, the dp4a instructions, four products each on the same
// patch, at about half their rate.
//
// Arithmetic order fixes the key bits, so it follows the TPU's:
// f32/bf16 part = (scores + |x|^2) + |q|^2 with q pre-scaled by -2 in the
// storage dtype; int8 part = max((f32(dot) * (qt * sr) + |x|^2) + |q|^2, 0)
// with qt = -2 * (query scale). __fmul_rn/__fadd_rn keep nvcc from
// contracting these into FMAs. The fp32 patch adds the products in ascending
// dimension order with __fmaf_rn from zero, so its f32 keys are those of a
// sequential fmaf loop; wgmma's fp32 sums are the hardware's order.
#include <climits>
#include <type_traits>

#include "score_tile.cuh"

namespace pqv {

struct BinArgs {
  const void* q;        // [B, d]: -2q in the storage dtype, or int8 codes
  const float* qsq;     // [B] |q|^2
  const float* qt;      // [B] -2 * query scale (int8)
  const void* emb;      // [n_pad, d] f32, bf16 or int8 codes
  const float* emb_sq;  // [n_pad] |x|^2, +3e38 on pad rows
  const float* scale;   // [n_pad] row scale (int8)
  const int* sel;       // [n_units] tile of each slot (K8), or null (K7)
  int* out;             // [expand * n_lg, B, 128], INT32_MAX on entry
  int B, d, tile, n_units, expand, tg_bits, code_bits, splits;
};

// The chunks of block (slab, split): the slots of slab block e = slab / n_lg
// in order (tile groups e, e + expand, ...; only the last tile group may be
// partial), cut into `splits` near-equal runs; chunk c is the lane group g3
// of slot(c) that folds into slab sl = slab % n_lg.
struct SlabChunks {
  const int* sel;
  int tile, n_lg, expand, e, sl, lo, n, tg_bits;

  __device__ __forceinline__ SlabChunks(const BinArgs& a, int slab, int split)
      : sel(a.sel), tile(a.tile), n_lg(a.tile / kTR), expand(a.expand),
        tg_bits(a.tg_bits) {
    e = slab / n_lg;
    sl = slab % n_lg;
    const int full = a.n_units / n_lg, rem = a.n_units % n_lg;
    const long long m_full = full > e ? (full - e + expand - 1) / expand : 0;
    const long long cnt = m_full * n_lg + ((rem && full % expand == e) ? rem : 0);
    lo = (int)(cnt * split / a.splits);
    n = (int)(cnt * (split + 1) / a.splits) - lo;
  }
  __device__ __forceinline__ int slot(int c) const {
    const int i = lo + c;
    return (e + (i / n_lg) * expand) * n_lg + i % n_lg;
  }
  __device__ __forceinline__ int g3(int s) const { return (sl - s % n_lg + n_lg) % n_lg; }
  // The first row of chunk c.
  __device__ __forceinline__ int operator()(int c) const {
    const int s = slot(c);
    return (sel != nullptr ? sel[s] : s) * tile + g3(s) * kTR;
  }
  // The provenance of chunk c's rows.
  __device__ __forceinline__ int code(int c) const {
    const int s = slot(c);
    return (g3(s) << tg_bits) + s / n_lg;
  }
};

// The epilogue: this thread's bins (query, lane) of the block's slab, one
// per accumulator position, and the chunk's norms (and int8 scales) staged
// beside the ring.
template <class Tile>
struct BinFold {
  static constexpr bool kInt8 = std::is_same_v<typename Tile::Storage, int8_t>;
  static constexpr int NQ = Tile::kPerThread;
  const SlabChunks& sched;
  const float* emb_sq;
  const float* scale;
  float* sqs;  // shared, [2][kTR]: the norms of this chunk and the next
  float* scs;  // shared, [2][kTR]: their row scales (int8)
  int hi_mask;
  float qsq[NQ], qt[NQ];
  int best[Tile::kGroups * Tile::kRun * NQ];

  __device__ __forceinline__ BinFold(const BinArgs& a, const SlabChunks& s, const Tile& t,
                                     int q0, char* mem)
      : sched(s), emb_sq(a.emb_sq), scale(a.scale), sqs(reinterpret_cast<float*>(mem)),
        scs(reinterpret_cast<float*>(mem) + 2 * kTR), hi_mask(~((1 << a.code_bits) - 1)) {
#pragma unroll
    for (int jq = 0; jq < NQ; ++jq) {
      const int b = q0 + t.query(jq);
      qsq[jq] = b < a.B ? a.qsq[b] : 0.f;
      qt[jq] = (kInt8 && b < a.B) ? a.qt[b] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < Tile::kGroups * Tile::kRun * NQ; ++i) best[i] = INT_MAX;
  }

  __device__ __forceinline__ void begin(int, int r0, int slot) {
    if (threadIdx.x < kTR) {
      sqs[slot * kTR + threadIdx.x] = emb_sq[r0 + threadIdx.x];
      if constexpr (kInt8) scs[slot * kTR + threadIdx.x] = scale[r0 + threadIdx.x];
    }
  }

  __device__ __forceinline__ void chunk(const Tile& t, int c, int, int slot) {
    const float* sq = sqs + slot * kTR;
    const float* sr = scs + slot * kTR;
    const int code = sched.code(c);
#pragma unroll
    for (int g = 0; g < Tile::kGroups; ++g) {
#pragma unroll
      for (int l = 0; l < Tile::kRun; ++l) {
        const int r = t.row_base(g) + l;
        const float s = sq[r];
        float rs = 0.f;
        if constexpr (kInt8) rs = sr[r];
#pragma unroll
        for (int jq = 0; jq < NQ; ++jq) {
          float p;
          if constexpr (kInt8) {
            const float sc =
                __fmul_rn(__int2float_rn(t.value(g, l, jq)), __fmul_rn(qt[jq], rs));
            p = __fadd_rn(__fadd_rn(sc, s), qsq[jq]);
            p = p < 0.f ? 0.f : p;  // quantization can push 0 below
          } else {
            p = __fadd_rn(__fadd_rn(t.value(g, l, jq), s), qsq[jq]);
          }
          int& bin = best[(g * Tile::kRun + l) * NQ + jq];
          bin = min(bin, (__float_as_int(p) & hi_mask) | code);
        }
      }
    }
  }

  // Fold the bins into the table's slab `slab`.
  __device__ __forceinline__ void write(const Tile& t, int* out, int slab, int q0, int B) const {
#pragma unroll
    for (int jq = 0; jq < NQ; ++jq) {
      const int b = q0 + t.query(jq);
      if (b >= B) continue;
      int* row = out + ((size_t)slab * B + b) * kTR;
#pragma unroll
      for (int g = 0; g < Tile::kGroups; ++g)
#pragma unroll
        for (int l = 0; l < Tile::kRun; ++l)
          atomicMin(row + t.row_base(g) + l, best[(g * Tile::kRun + l) * NQ + jq]);
    }
  }
};

constexpr int kBinStages = 3;

// 128 queries a block keep 64 sums and 64 bins a thread: one block an SM.
template <class Tile>
constexpr int bin_blocks_per_sm() {
  return Tile::kQueries == 128 ? 1 : 2;
}

template <class Tile>
constexpr int binscan_smem() {
  return 1024 + kBinStages * Tile::kStageBytes + 4 * kTR * 4;
}

template <class Tile>
__global__ void __launch_bounds__(kThreads, bin_blocks_per_sm<Tile>())
    binscan_kernel(BinArgs a) {
  extern __shared__ char dyn[];
  char* ring = align_ring(dyn);
  const SlabChunks sched(a, blockIdx.y, blockIdx.z);
  if (sched.n <= 0) return;  // uniform across the block
  using T = typename Tile::Storage;
  const TileOperands<T> op = {static_cast<const T*>(a.q), static_cast<const T*>(a.emb), a.B,
                              a.d};
  const int q0 = blockIdx.x * Tile::kQueries;
  Tile t;
  BinFold<Tile> epi(a, sched, t, q0, ring + kBinStages * Tile::kStageBytes);
  walk_list<kBinStages>(t, op, q0, sched.n, sched, ring, epi);
  epi.write(t, a.out, blockIdx.y, q0, a.B);
}

template <class Tile>
int launch_binscan(const BinArgs& a, cudaStream_t st) {
  auto kernel = binscan_kernel<Tile>;
  constexpr int smem = binscan_smem<Tile>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ceil_div(a.B, Tile::kQueries), a.expand * (a.tile / kTR), a.splits);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// dtype 0 f32, 1 bf16, 2 int8; wgmma: bf16 on the tensor cores, which needs
// d % 8 == 0 and 16-byte aligned arrays. A batch of at most 64 takes the
// 64-query patch on the CUDA cores.
int dispatch_binscan(const BinArgs& a, int dtype, int wgmma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.tile % kTR || a.splits < 1) return (int)cudaErrorInvalidValue;
  if (wgmma) {
    if (dtype != 1 || a.d % 8 || ((uintptr_t)a.q | (uintptr_t)a.emb) % 16)
      return (int)cudaErrorInvalidValue;
    return launch_binscan<MmaTile>(a, st);
  }
  const bool wide = a.B > 64;
  switch (dtype) {
    case 0:
      return wide ? launch_binscan<FmaTile<float, 8>>(a, st)
                  : launch_binscan<FmaTile<float, 4>>(a, st);
    case 1:
      return wide ? launch_binscan<FmaTile<__nv_bfloat16, 8>>(a, st)
                  : launch_binscan<FmaTile<__nv_bfloat16, 4>>(a, st);
    case 2:
      return wide ? launch_binscan<Dp4aTile<8>>(a, st) : launch_binscan<Dp4aTile<4>>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

BinArgs bin_args(const void* q, const float* qsq, const float* qt,
                 const void* emb, const float* emb_sq, const float* scale,
                 const int* sel, int B, int d, int tile, int n_units,
                 int expand, int tg_bits, int code_bits, int splits, int* out) {
  BinArgs a = {};
  a.q = q;
  a.qsq = qsq;
  a.qt = qt;
  a.emb = emb;
  a.emb_sq = emb_sq;
  a.scale = scale;
  a.sel = sel;
  a.out = out;
  a.B = B;
  a.d = d;
  a.tile = tile;
  a.n_units = n_units;
  a.expand = expand;
  a.tg_bits = tg_bits;
  a.code_bits = code_bits;
  a.splits = splits;
  return a;
}

}  // namespace pqv

// K7: every tile; n_units = nt. dtype 0 f32, 1 bf16, 2 int8 (qt and scale
// are read only then); wgmma as for dispatch_binscan. out [expand *
// tile/128, B, 128] holds INT32_MAX.
extern "C" int pqv_binned_scan(const void* q, const float* qsq, const float* qt,
                               const void* emb, const float* emb_sq,
                               const float* scale, int B, int d, int tile,
                               int n_units, int expand, int tg_bits,
                               int code_bits, int splits, int dtype, int wgmma,
                               int* out, void* stream) {
  return pqv::dispatch_binscan(
      pqv::bin_args(q, qsq, qt, emb, emb_sq, scale, nullptr, B, d, tile,
                    n_units, expand, tg_bits, code_bits, splits, out),
      dtype, wgmma, stream);
}

// K8: slot t scans tile sel[t]; n_units = cap, the length of sel.
extern "C" int pqv_binned_scan_select(const void* q, const float* qsq,
                                      const float* qt, const void* emb,
                                      const float* emb_sq, const float* scale,
                                      const int* sel, int B, int d, int tile,
                                      int n_units, int expand, int tg_bits,
                                      int code_bits, int splits, int dtype,
                                      int wgmma, int* out, void* stream) {
  return pqv::dispatch_binscan(
      pqv::bin_args(q, qsq, qt, emb, emb_sq, scale, sel, B, d, tile, n_units,
                    expand, tg_bits, code_bits, splits, out),
      dtype, wgmma, stream);
}

// Dynamic shared memory of a K7/K8 launch, for the wrapper's own reckoning:
// backend 0 the fp32 patch, 1 wgmma, 2 the dp4a patch.
extern "C" int pqv_binned_scan_smem(int backend, int block_queries) {
  using namespace pqv;
  if (backend == 1) return binscan_smem<MmaTile>();
  if (backend == 2)
    return block_queries > 64 ? binscan_smem<Dp4aTile<8>>() : binscan_smem<Dp4aTile<4>>();
  return block_queries > 64 ? binscan_smem<FmaTile<float, 8>>()
                            : binscan_smem<FmaTile<float, 4>>();
}
