// K4: masked IVF scan over a cluster-sorted layout with a local mask.
// K5: exact per-tile top-k. K6: per-tile top-k masked by a global probe mask,
// any layout.
//
// Replace pqvector_tpu/kernels/scan_topk.py: pallas_masked_local_topk
// (_masked_local_scan_kernel), pallas_exact_topk (_scan_kernel) and
// pallas_masked_topk (_masked_scan_kernel), with _extract_topk in each.
//
// The TPU kernel extracts each tile's top-k by k min-passes over a [B, tile]
// score block and tests the probe through a one-hot matmul of the
// pre-gathered mask lmask [nt, B, cmax]. All three write the per-tile
// winners [nt, B, k]; the cross-tile merge and the f32 re-score stay
// outside, as in the JAX package.
//
// K5 and K4 are built on the score tile of score_tile.cuh. One block owns a
// tile and up to 128 queries, so at B = 256 the rows are read twice, and the
// two blocks of a tile are neighbours in the grid, so the second read finds
// them in L2. The sums of a 128-row chunk stay in registers; the chunk's
// scores |x|^2 - 2 q.x go to shared memory 64 rows at a time, and there one
// thread per query marks the scores that beat its list's largest entry,
// which it keeps in registers, and puts each survivor in that entry's place
// (TopkLists in topk_lists.cuh, which K2 shares). The lists live in
// dynamic shared memory sized by the call's k, entry-major ([k][query]) so
// that 32 queries' threads touch 32 banks; they are unordered until the tile
// is done and are then ranked under the (distance, id) order, so the result
// is what a stable sort gives whatever order the rows came in. What bounds
// K5 on the H100: f32 storage, the fp32 FMAs (2 B n_pad d against 67
// TFLOP/s), fed at 4 shared loads per 64 FMAs, which keeps the shared-memory
// pipe as busy as the FMA pipe; bf16 storage (wgmma), the list work, about
// k (1 + ln(tile / k)) replacements per query and tile because every tile's
// lists start empty, each a pass over k entries, and at k = 128 the ranking
// (k^2 comparisons per query).
//
// K4 is K5's walk with the probe test as epilogue work and lists of its own
// (MaskedLists in topk_lists.cuh: sorted, drained a query at a time by a
// whole warp, because the rows a query probes are near it and many of them
// enter its list). A query probes a few of a thousand clusters, so nearly
// every (query, row) pair is unprobed, and the work follows the probed pairs
// at three grains: a block whose queries probe none of its tile's slots
// writes empty lists and is gone; of a probed tile it copies and multiplies
// only the 128-row chunks that hold a row some query probes; and of a scored
// chunk it dumps and drains only the queries that probe a slot of that 64-row
// half. The block holds its queries' slice of lmask for the tile as bits in
// shared memory. A block owns 128 queries on wgmma and 64 on the fp32 patch,
// where the products are the time and fewer queries probe fewer chunks.
// What bounds it on the H100 (scripts/torch_masked_epilogue_profile.py, 1M x
// 128, B = 256, k = 10, bf16): the list work on the probed rows, half of the
// kernel; the probe flags, sparse dumps and two barriers of each scored
// half, a quarter; the walk itself, a quarter. In f32 the fp32 FMAs of the
// scored chunks are three quarters.
//
// K6 is K4 with the probe read through each row's cluster id: a row's slot
// is its cluster, and the test is mask[b, row_cluster[row]] (the TPU kernel
// ships the ids as f32 and tests them through a one-hot matmul, a Mosaic
// workaround). On a layout in file order every tile holds rows of most
// clusters, so a per-tile table rules nothing out; K6's probe table is its
// queries' rows of the batch's mask, the same for every tile, held in shared
// memory as the set of the block's queries that probe each cluster
// (ClusterLists in topk_lists.cuh). Building it reads B x kc_pad floats of
// the mask, so a block walks a run of tiles (u, u + units, ...), about one
// wave of them, and writes each tile's lists in turn. Of a tile it scores
// the 128-row chunks that hold a row of a cluster some of its queries probe
// (at B = 256 nearly all; at small B few); of a 64-row half it appends each
// probed pair to its query's candidates and then one thread a query puts
// them into its list. What bounds it on the H100
// (scripts/torch_masked_epilogue_profile.py, 1M x 128 in file order, B = 256,
// k = 10, bf16, device time): the walk 0.30 ms of 0.98, the probe bits,
// appends and two barriers of each half 0.38, the list work 0.30; one block
// an SM, since the table takes the room of a second. Where the table does
// not fit beside the lists (k near 128 on wgmma, or tens of thousands of
// clusters), K6 runs K4's kernel instead, reading the mask and the clusters
// from device memory per pair and scoring every chunk, block (tile, query
// group); those L2 reads bound it. Pad rows carry cluster id kc, whose mask
// slot is never set.
#include "topk_lists.cuh"

namespace pqv {

// ---------------------------------------------------------------- K5

template <class Tile, int STAGES>
__global__ void __launch_bounds__(kThreads, 2)
    exact_topk_kernel(TileOperands<typename Tile::Storage> op,
                      const float* __restrict__ emb_sq, float* __restrict__ out_d,
                      int* __restrict__ out_i, int k, int tile, int nqb) {
  extern __shared__ char dyn[];
  char* ring = align_ring(dyn);
  Tile t;
  TopkLists<Tile> epi;
  epi.attach(ring + STAGES * Tile::kStageBytes, emb_sq, k);
  const int unit = blockIdx.x / nqb;
  const int q0 = (blockIdx.x % nqb) * Tile::kQueries;
  epi.row_end = (unit + 1) * tile;
  walk_rows<STAGES>(t, op, q0, unit * tile, epi.row_end, ring, epi);
  epi.write(out_d, out_i, unit, q0, op.B);
}

template <class Tile, int STAGES>
int launch_exact_topk(const void* q, const void* emb, const float* emb_sq, float* out_d,
                      int* out_i, int B, int d, int n_pad, int k, int tile,
                      cudaStream_t st) {
  using T = typename Tile::Storage;
  TileOperands<T> op = {static_cast<const T*>(q), static_cast<const T*>(emb), B, d};
  auto kernel = exact_topk_kernel<Tile, STAGES>;
  const int smem = topk_lists_smem<Tile, STAGES>(k);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nqb = ceil_div(B, Tile::kQueries);
  kernel<<<(n_pad / tile) * nqb, kThreads, smem, st>>>(op, emb_sq, out_d, out_i, k, tile,
                                                       nqb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K4

template <class Tile, int STAGES, bool TABLE>
__global__ void __launch_bounds__(kThreads, 2)
    masked_local_kernel(TileOperands<typename Tile::Storage> op,
                        const float* __restrict__ emb_sq, const int* __restrict__ lcl,
                        ProbeSource src, float* __restrict__ out_d,
                        int* __restrict__ out_i, int k, int tile, int words, int nqb) {
  extern __shared__ char dyn[];
  char* ring = align_ring(dyn);
  Tile t;
  MaskedLists<Tile, TABLE> epi;
  epi.layout(ring + STAGES * Tile::kStageBytes, emb_sq, k, words);
  const int unit = blockIdx.x / nqb;
  const int q0 = (blockIdx.x % nqb) * Tile::kQueries;
  epi.lcl = lcl;
  epi.src = src;
  epi.q0 = q0;
  if (!epi.load_table(unit)) {
    // None of the block's queries probes this tile: its lists are empty.
    const int nq = min(Tile::kQueries, op.B - q0);
    const size_t at = ((size_t)unit * op.B + q0) * k;
    for (int e = threadIdx.x; e < nq * k; e += kThreads) {
      out_d[at + e] = kPosInf;
      out_i[at + e] = -1;
    }
    return;
  }
  epi.clear();
  walk_masked_tile<STAGES>(t, op, q0, unit, tile, ring, epi);
  __syncthreads();  // the lists are complete, also where no chunk was scored
  epi.write(out_d, out_i, unit, q0, op.B);
}

template <class Tile, int STAGES>
int launch_masked_local(const void* q, const void* emb, const float* emb_sq,
                        const int* lcl, const ProbeSource& src, float* out_d, int* out_i,
                        int d, int n_pad, int k, int tile, int words, cudaStream_t st) {
  using T = typename Tile::Storage;
  TileOperands<T> op = {static_cast<const T*>(q), static_cast<const T*>(emb), src.B, d};
  auto kernel = words > 0 ? masked_local_kernel<Tile, STAGES, true>
                          : masked_local_kernel<Tile, STAGES, false>;
  const int smem = masked_lists_smem<Tile, STAGES>(k, words);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nqb = ceil_div(src.B, Tile::kQueries);
  kernel<<<(n_pad / tile) * nqb, kThreads, smem, st>>>(op, emb_sq, lcl, src, out_d, out_i,
                                                       k, tile, words, nqb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K6

// 128 queries a block on wgmma leave room for one block an SM beside the
// probe table; the 64-query patch fits two.
template <class Tile>
constexpr int k6_blocks_per_sm() {
  return Tile::kQueries == 128 ? 1 : 2;
}

template <class Tile, int STAGES>
__global__ void __launch_bounds__(kThreads, k6_blocks_per_sm<Tile>())
    masked_topk_kernel(TileOperands<typename Tile::Storage> op,
                       const float* __restrict__ emb_sq, const int* __restrict__ rcl,
                       const float* __restrict__ mask, int kc_pad, int* stats,
                       float* __restrict__ out_d, int* __restrict__ out_i, int k, int tile,
                       int nt, int units, int nqb) {
  extern __shared__ char dyn[];
  char* ring = align_ring(dyn);
  Tile t;
  ClusterLists<Tile> epi;
  epi.layout(ring + STAGES * Tile::kStageBytes, emb_sq, k, kc_pad);
  epi.rcl = rcl;
  const int unit = blockIdx.x / nqb;
  const int q0 = (blockIdx.x % nqb) * Tile::kQueries;
  const bool any = epi.load_table(mask, q0, op.B);
  int tiles = 0, chunks = 0;
  for (int u = unit; u < nt; u += units) {
    epi.clear();
    const int tile_end = (u + 1) * tile;
    epi.row_end = tile_end;
    int scored = 0;
    for (int seg0 = u * tile; any && seg0 < tile_end; seg0 += kSegmentChunks * kTR) {
      const int seg_end = min(seg0 + kSegmentChunks * kTR, tile_end);
      const MaskChunks picked = {epi.pick_chunks(seg0, seg_end)};
      scored += __popc(picked.mask);
      __syncthreads();  // every thread has left the last walk and read the word
      walk_chunks<STAGES>(t, op, q0, seg0, seg_end, ring, epi, picked);
    }
    tiles += scored > 0;
    chunks += scored;
    __syncthreads();  // the lists are complete, also where no chunk was scored
    epi.write(out_d, out_i, u, q0, op.B);
    __syncthreads();  // the lists are read before the next tile clears them
  }
  if (stats != nullptr && threadIdx.x == 0 && tiles > 0) {
    atomicAdd(stats, tiles);
    atomicAdd(stats + 1, chunks);
  }
}

template <class Tile, int STAGES>
int launch_masked_topk(const void* q, const void* emb, const float* emb_sq, const int* rcl,
                       const float* mask, int kc_pad, int* stats, float* out_d, int* out_i,
                       int B, int d, int n_pad, int k, int tile, int units, cudaStream_t st) {
  using T = typename Tile::Storage;
  TileOperands<T> op = {static_cast<const T*>(q), static_cast<const T*>(emb), B, d};
  auto kernel = masked_topk_kernel<Tile, STAGES>;
  const int smem = cluster_lists_smem<Tile, STAGES>(k, kc_pad);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nqb = ceil_div(B, Tile::kQueries);
  kernel<<<units * nqb, kThreads, smem, st>>>(op, emb_sq, rcl, mask, kc_pad, stats, out_d,
                                              out_i, k, tile, n_pad / tile, units, nqb);
  return (int)cudaGetLastError();
}

}  // namespace pqv

// K5: q [B, d] and emb [n_pad, d] in the storage dtype; out [nt, B, k] with
// (+3e38, -1) in empty slots. wgmma picks the tensor-core back end: bf16,
// d % 8 == 0 and both arrays 16-byte aligned.
extern "C" int pqv_exact_topk(const void* q, const void* emb, const float* emb_sq,
                              int B, int d, int n_pad, int k, int tile,
                              int is_bf16, int wgmma, float* out_d, int* out_i,
                              void* stream) {
  using namespace pqv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (wgmma) {
    if (!is_bf16 || d % 8 || ((uintptr_t)q | (uintptr_t)emb) % 16)
      return (int)cudaErrorInvalidValue;
    return launch_exact_topk<MmaTile, kTopkMmaStages>(q, emb, emb_sq, out_d, out_i, B, d,
                                                      n_pad, k, tile, st);
  }
  if (is_bf16) {
    if (B > 64)
      return launch_exact_topk<FmaTile<__nv_bfloat16, 8>, kTopkFmaStages>(
          q, emb, emb_sq, out_d, out_i, B, d, n_pad, k, tile, st);
    return launch_exact_topk<FmaTile<__nv_bfloat16, 4>, kTopkFmaStages>(
        q, emb, emb_sq, out_d, out_i, B, d, n_pad, k, tile, st);
  }
  if (B > 64)
    return launch_exact_topk<FmaTile<float, 8>, kTopkFmaStages>(
        q, emb, emb_sq, out_d, out_i, B, d, n_pad, k, tile, st);
  return launch_exact_topk<FmaTile<float, 4>, kTopkFmaStages>(
      q, emb, emb_sq, out_d, out_i, B, d, n_pad, k, tile, st);
}

// Dynamic shared memory of K5's launch, for the wrapper's own reckoning.
extern "C" int pqv_exact_topk_smem(int wgmma, int block_queries, int k) {
  using namespace pqv;
  if (wgmma) return topk_lists_smem<MmaTile, kTopkMmaStages>(k);
  return block_queries > 64 ? topk_lists_smem<FmaTile<float, 8>, kTopkFmaStages>(k)
                            : topk_lists_smem<FmaTile<float, 4>, kTopkFmaStages>(k);
}

// K6: adds row_cluster [n_pad] int32 (kc on pad rows) and the probe mask
// [B, kc_pad] f32 (kc_pad a multiple of 128); out [nt, B, k]. wgmma picks the
// tensor-core back end as for K5. units > 0: the probe table in shared
// memory (ClusterLists), block (u, query group) walking tiles u, u + units,
// ...; units = 0: K4's kernel reading the mask from device memory, block
// (tile, query group). stats is null or two int32 counters the launch adds
// the (block, tile) and (block, chunk) pairs it scored to.
extern "C" int pqv_masked_topk(const void* q, const void* emb, const float* emb_sq,
                               const int* row_cluster, const float* mask, int B,
                               int d, int n_pad, int k, int tile, int kc_pad,
                               int is_bf16, int wgmma, int units, int* stats,
                               float* out_d, int* out_i, void* stream) {
  using namespace pqv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || kc_pad < 1 || kc_pad % 128 || units < 0 ||
      (wgmma && (!is_bf16 || d % 8 || ((uintptr_t)q | (uintptr_t)emb) % 16)))
    return (int)cudaErrorInvalidValue;
  if (units > 0) {
    if (wgmma)
      return launch_masked_topk<MmaTile, kTopkMmaStages>(q, emb, emb_sq, row_cluster, mask,
                                                         kc_pad, stats, out_d, out_i, B, d,
                                                         n_pad, k, tile, units, st);
    if (is_bf16)
      return launch_masked_topk<FmaTile<__nv_bfloat16, 4>, kTopkFmaStages>(
          q, emb, emb_sq, row_cluster, mask, kc_pad, stats, out_d, out_i, B, d, n_pad, k,
          tile, units, st);
    return launch_masked_topk<FmaTile<float, 4>, kTopkFmaStages>(
        q, emb, emb_sq, row_cluster, mask, kc_pad, stats, out_d, out_i, B, d, n_pad, k, tile,
        units, st);
  }
  const ProbeSource src = {nullptr, mask, B, kc_pad, kc_pad, stats};
  if (wgmma)
    return launch_masked_local<MmaTile, kTopkMmaStages>(q, emb, emb_sq, row_cluster, src,
                                                        out_d, out_i, d, n_pad, k, tile, 0, st);
  if (is_bf16)
    return launch_masked_local<FmaTile<__nv_bfloat16, 4>, kTopkFmaStages>(
        q, emb, emb_sq, row_cluster, src, out_d, out_i, d, n_pad, k, tile, 0, st);
  return launch_masked_local<FmaTile<float, 4>, kTopkFmaStages>(
      q, emb, emb_sq, row_cluster, src, out_d, out_i, d, n_pad, k, tile, 0, st);
}

// Dynamic shared memory of K6's launch with its probe table, for the
// wrapper's own reckoning.
extern "C" int pqv_masked_topk_smem(int wgmma, int block_queries, int k, int kc_pad) {
  using namespace pqv;
  if (wgmma) return cluster_lists_smem<MmaTile, kTopkMmaStages>(k, kc_pad);
  return block_queries > 64 ? cluster_lists_smem<FmaTile<float, 8>, kTopkFmaStages>(k, kc_pad)
                            : cluster_lists_smem<FmaTile<float, 4>, kTopkFmaStages>(k, kc_pad);
}

// K4: q [B, d] and emb [n_pad, d] in the storage dtype (bf16 when is_bf16);
// lcl [n_pad] int32, lmask [nt, B, cmax] f32; out [nt, B, k]. wgmma picks the
// tensor-core back end as for K5; words is the probe table's width in 32-bit
// words a query, ceil(cmax / 32) up to 8, or 0 to read lmask from device
// memory in the epilogue; stats is null or two int32 counters the launch adds
// the (block, tile) and (block, chunk) pairs it scored to.
extern "C" int pqv_masked_local_topk(const void* q, const void* emb,
                                     const float* emb_sq, const int* lcl,
                                     const float* lmask, int B, int d,
                                     int n_pad, int k, int tile, int cmax,
                                     int is_bf16, int wgmma, int words, int* stats,
                                     float* out_d, int* out_i, void* stream) {
  using namespace pqv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || cmax < 1 || words < 0 || words > kTableWordsMax ||
      (words > 0 && 32 * words < cmax) ||
      (wgmma && (!is_bf16 || d % 8 || ((uintptr_t)q | (uintptr_t)emb) % 16)))
    return (int)cudaErrorInvalidValue;
  const ProbeSource src = {lmask, nullptr, B, cmax, 0, stats};
  if (wgmma)
    return launch_masked_local<MmaTile, kTopkMmaStages>(q, emb, emb_sq, lcl, src, out_d,
                                                        out_i, d, n_pad, k, tile, words, st);
  // The fp32 patch scores 64 queries a block whatever the batch: fewer
  // queries probe fewer of a tile's chunks, and two blocks fit an SM up to k = 100.
  if (is_bf16)
    return launch_masked_local<FmaTile<__nv_bfloat16, 4>, kTopkFmaStages>(
        q, emb, emb_sq, lcl, src, out_d, out_i, d, n_pad, k, tile, words, st);
  return launch_masked_local<FmaTile<float, 4>, kTopkFmaStages>(
      q, emb, emb_sq, lcl, src, out_d, out_i, d, n_pad, k, tile, words, st);
}

// Dynamic shared memory of K4's launch, for the wrapper's own reckoning.
extern "C" int pqv_masked_local_topk_smem(int wgmma, int block_queries, int k, int words) {
  using namespace pqv;
  if (wgmma) return masked_lists_smem<MmaTile, kTopkMmaStages>(k, words);
  return block_queries > 64 ? masked_lists_smem<FmaTile<float, 8>, kTopkFmaStages>(k, words)
                            : masked_lists_smem<FmaTile<float, 4>, kTopkFmaStages>(k, words);
}
