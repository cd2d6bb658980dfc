// K2 and K3: streaming threshold top-k, exact and IVF-masked.
//
// Replaces pqvector_tpu/kernels/stream_topk.py: pallas_stream_exact_topk
// (K2, _exact_kernel) and pallas_stream_masked_topk (K3, _masked_kernel).
//
// The TPU kernels carry one [B, 128] accumulator across a grid that runs in
// order. A CUDA grid has no order, so here a block owns some queries and a
// share of the rows (a unit), keeps its own top-k lists in shared memory and
// writes them as partials [U, B, k]; a second launch merges the U partial
// lists of each query. Every list orders on (distance, id), so the result
// does not depend on the split.
//
// K2 runs on the score tile of score_tile.cuh with the lists of
// topk_lists.cuh for an epilogue, as K5 does, with two differences. A block
// owns up to 128 queries and a run of consecutive rows (a multiple of 128,
// many tiles), not one tile, and its lists live across the whole run: they
// start empty once, and the list's largest entry gates every later row, the
// carried threshold of the TPU kernel. That cuts the list replacements from
// about k (1 + ln(tile / k)) per tile to k (1 + ln(run / k)) per run; a full
// list is kept as a binary max-heap, so each costs log2(k) steps; and the
// blocks share one gate per query in device memory (the smallest k-th entry
// any of them has reached, by atomicMin), so a row that can be in no global
// top-k is dropped by every block (topk_lists.cuh, STREAM). The
// runs are sized so that the launch is about one wave of two blocks an SM,
// and the query groups of one run are neighbours in the grid, so the later
// ones find the rows in L2. f32 storage runs FmaTile (IEEE fp32, __fmaf_rn,
// ascending dimensions: the scores |x|^2 - 2 q.x are bit for bit those of a
// sequential fmaf loop), bf16 storage with d % 8 == 0 and 16-byte aligned
// arrays MmaTile (wgmma), other bf16 widths widen into FmaTile. What bounds
// it on the H100: f32, the fp32 FMAs fed at 4 shared loads per 64 FMAs (the
// shared-memory pipe is as busy as the FMA pipe, about half the 67 TFLOP/s
// peak); bf16 on wgmma, the list work and the 64-row score dumps between the
// products; at k near 128 the replacements, each a pass over k entries.
//
// K3 is K2's stream with the probe test as epilogue work (MaskedLists in
// topk_lists.cuh, which K4 shares). Block (u, g) owns up to 128 queries and
// the active tiles u, u + U, ... of the device-side schedule (n_active, then
// the active tile ids), so the host never waits for the probe mask, and its
// lists (sorted, drained a query at a time by a whole warp) and the shared
// gate live across that run. Before a tile it
// builds its queries' probe table for the tile in shared memory from
// mask[b, tc[tile, slot]], which is K4's local mask made in place, so no
// [nt, B, cmax] buffer exists. It skips a tile that none of its own queries
// probes (the schedule only says that some query of the batch does), copies
// and multiplies only the 128-row chunks that hold a probed row, and dumps
// and drains only the queries that probe a slot of a 64-row half. The gate
// holds under a mask: a list holds only rows its query probes, so a row
// above some full list's k-th entry is in no top-k of that query. U is
// sized so that the launch is about one wave. What bounds it: as K4
// (scan_topk.cu), the list work on the probed rows first, then the flags,
// dumps and barriers of the scored halves and the per-tile tables, then the
// walk; in f32 the fp32 FMAs of the scored chunks.
#include "topk_lists.cuh"

namespace pqv {

// The gates of a launch start above the +3e38 sentinel: 0x7f7f7f7f is 3.39e38.
static cudaError_t open_gates(int* gate, int B, cudaStream_t st) {
  return cudaMemsetAsync(gate, 0x7f, (size_t)B * sizeof(int), st);
}

template <class Tile, int STAGES>
__global__ void __launch_bounds__(kThreads, 2)
    stream_exact_kernel(TileOperands<typename Tile::Storage> op,
                        const float* __restrict__ emb_sq, float* __restrict__ part_d,
                        int* __restrict__ part_i, int* gate, int k,
                        int n_pad, int run, int nqb) {
  extern __shared__ char dyn[];
  char* ring = align_ring(dyn);
  Tile t;
  TopkLists<Tile, true> epi;
  epi.attach(ring + STAGES * Tile::kStageBytes, emb_sq, k);
  const int unit = blockIdx.x / nqb;
  const int q0 = (blockIdx.x % nqb) * Tile::kQueries;
  epi.gate = gate + q0;
  epi.nq = min(Tile::kQueries, op.B - q0);
  const int row_begin = unit * run;
  epi.row_end = min(row_begin + run, n_pad);
  walk_rows<STAGES>(t, op, q0, row_begin, epi.row_end, ring, epi);
  __syncthreads();  // the lists are complete, also where the run held no row
  epi.write(part_d, part_i, unit, q0, op.B);
}

template <class Tile, int STAGES>
int launch_stream_exact(const void* q, const void* emb, const float* emb_sq,
                        float* part_d, int* part_i, int* gate, int B, int d, int n_pad,
                        int k, int run, cudaStream_t st) {
  using T = typename Tile::Storage;
  TileOperands<T> op = {static_cast<const T*>(q), static_cast<const T*>(emb), B, d};
  auto kernel = stream_exact_kernel<Tile, STAGES>;
  const int smem = topk_lists_smem<Tile, STAGES>(k);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = open_gates(gate, B, st);
  if (err != cudaSuccess) return (int)err;
  const int nqb = ceil_div(B, Tile::kQueries);
  kernel<<<ceil_div(n_pad, run) * nqb, kThreads, smem, st>>>(op, emb_sq, part_d, part_i,
                                                              gate, k, n_pad, run, nqb);
  return (int)cudaGetLastError();
}

template <class Tile, int STAGES, bool TABLE>
__global__ void __launch_bounds__(kThreads, 2)
    stream_masked_kernel(TileOperands<typename Tile::Storage> op,
                         const float* __restrict__ emb_sq, const int* __restrict__ lcl,
                         ProbeSource src, const int* __restrict__ sched,
                         float* __restrict__ part_d, int* __restrict__ part_i, int* gate,
                         int k, int tile, int words, int units, int nqb) {
  extern __shared__ char dyn[];
  char* ring = align_ring(dyn);
  Tile t;
  MaskedLists<Tile, true, TABLE> epi;
  epi.layout(ring + STAGES * Tile::kStageBytes, emb_sq, k, words);
  epi.clear();
  const int unit = blockIdx.x / nqb;
  const int q0 = (blockIdx.x % nqb) * Tile::kQueries;
  epi.lcl = lcl;
  epi.src = src;
  epi.q0 = q0;
  epi.gate = gate + q0;
  const int n_active = sched[0];
  for (int i = unit; i < n_active; i += units) {
    const int tl = sched[1 + i];
    if (epi.load_table(tl)) walk_masked_tile<STAGES>(t, op, q0, tl, tile, ring, epi);
  }
  __syncthreads();  // the lists are complete, also where the run scored no row
  epi.write(part_d, part_i, unit, q0, op.B);
}

template <class Tile, int STAGES>
int launch_stream_masked(const void* q, const void* emb, const float* emb_sq,
                         const int* lcl, const ProbeSource& src, const int* sched,
                         float* part_d, int* part_i, int* gate, int d, int k, int tile,
                         int words, int units, cudaStream_t st) {
  using T = typename Tile::Storage;
  TileOperands<T> op = {static_cast<const T*>(q), static_cast<const T*>(emb), src.B, d};
  auto kernel = words > 0 ? stream_masked_kernel<Tile, STAGES, true>
                          : stream_masked_kernel<Tile, STAGES, false>;
  const int smem = masked_lists_smem<Tile, STAGES>(k, words);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = open_gates(gate, src.B, st);
  if (err != cudaSuccess) return (int)err;
  const int nqb = ceil_div(src.B, Tile::kQueries);
  kernel<<<units * nqb, kThreads, smem, st>>>(op, emb_sq, lcl, src, sched, part_d, part_i,
                                              gate, k, tile, words, units, nqb);
  return (int)cudaGetLastError();
}

// One warp per query: merge the [U, B, k] partial lists into [B, k].
__global__ void __launch_bounds__(kThreads)
    merge_partials_kernel(const float* pd, const int* pi, int units, int B,
                          int k, float* out_d, int* out_i) {
  __shared__ float ld[kWarps][kMaxK];
  __shared__ int li[kWarps][kMaxK];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  init_lists(ld, li, kWarps);
  __syncthreads();
  const int b = blockIdx.x * kWarps + w;
  if (b >= B) return;  // whole warp leaves; no block barrier follows
  const int total = units * k;
  for (int j0 = 0; j0 < total; j0 += 32) {
    const int j = j0 + lane;
    const bool valid = j < total;
    float cd = kPosInf;
    int cid = -1;
    if (valid) {
      const size_t o = ((size_t)(j / k) * B + b) * k + (j % k);
      cd = pd[o];
      cid = pi[o];
    }
    warp_offer(ld[w], li[w], k, cd, cid, valid, lane);
  }
  for (int j = lane; j < k; j += 32) {
    out_d[(size_t)b * k + j] = ld[w][j];
    out_i[(size_t)b * k + j] = li[w][j];
  }
}

static int merge(const float* part_d, const int* part_i, int units, int B, int k,
                 float* out_d, int* out_i, cudaStream_t stream) {
  merge_partials_kernel<<<ceil_div(B, kWarps), kThreads, 0, stream>>>(
      part_d, part_i, units, B, k, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // namespace pqv

// K2: q [B, d] and emb [n_pad, d] in the storage dtype (bf16 when is_bf16),
// emb_sq [n_pad] f32 with +3e38 on pad rows; a block owns `run` consecutive
// rows (a multiple of 128); part_d/part_i [ceil(n_pad / run), B, k] and gate
// [B] int32 scratch; out_d/out_i [B, k]. wgmma picks the tensor-core back end: bf16, d % 8 == 0
// and both arrays 16-byte aligned.
extern "C" int pqv_stream_exact_topk(const void* q, const void* emb,
                                     const float* emb_sq, int B, int d,
                                     int n_pad, int k, int run, int is_bf16,
                                     int wgmma, float* part_d, int* part_i,
                                     int* gate, float* out_d, int* out_i,
                                     void* stream) {
  using namespace pqv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || run < kTR || run % kTR) return (int)cudaErrorInvalidValue;
  int rc;
  if (wgmma) {
    if (!is_bf16 || d % 8 || ((uintptr_t)q | (uintptr_t)emb) % 16)
      return (int)cudaErrorInvalidValue;
    rc = launch_stream_exact<MmaTile, kTopkMmaStages>(q, emb, emb_sq, part_d, part_i, gate,
                                                      B, d, n_pad, k, run, st);
  } else if (is_bf16) {
    rc = B > 64 ? launch_stream_exact<FmaTile<__nv_bfloat16, 8>, kTopkFmaStages>(
                      q, emb, emb_sq, part_d, part_i, gate, B, d, n_pad, k, run, st)
                : launch_stream_exact<FmaTile<__nv_bfloat16, 4>, kTopkFmaStages>(
                      q, emb, emb_sq, part_d, part_i, gate, B, d, n_pad, k, run, st);
  } else {
    rc = B > 64 ? launch_stream_exact<FmaTile<float, 8>, kTopkFmaStages>(
                      q, emb, emb_sq, part_d, part_i, gate, B, d, n_pad, k, run, st)
                : launch_stream_exact<FmaTile<float, 4>, kTopkFmaStages>(
                      q, emb, emb_sq, part_d, part_i, gate, B, d, n_pad, k, run, st);
  }
  if (rc != 0) return rc;
  return merge(part_d, part_i, ceil_div(n_pad, run), B, k, out_d, out_i, st);
}

// Dynamic shared memory of K2's launch, for the wrapper's own reckoning.
extern "C" int pqv_stream_exact_topk_smem(int wgmma, int block_queries, int k) {
  using namespace pqv;
  if (wgmma) return topk_lists_smem<MmaTile, kTopkMmaStages>(k);
  return block_queries > 64 ? topk_lists_smem<FmaTile<float, 8>, kTopkFmaStages>(k)
                            : topk_lists_smem<FmaTile<float, 4>, kTopkFmaStages>(k);
}

// K3: q, emb and emb_sq as for K2; adds lcl [n_pad] and tc [nt, cmax] int32,
// mask [B, kc_pad] f32 and the schedule sched [nt + 1] int32 (n_active, then
// active tile ids); a block owns the active tiles u, u + units, ...;
// part_d/part_i [units, B, k] and gate [B] int32 scratch. wgmma as for K2;
// words is the probe table's width in 32-bit words a query, ceil(cmax / 32)
// up to 8, or 0 to read mask and tc from device memory in the epilogue; stats
// is null or two int32 counters the launch adds the (block, tile) and
// (block, chunk) pairs it scored to.
extern "C" int pqv_stream_masked_topk(
    const void* q, const void* emb, const float* emb_sq, const int* lcl,
    const int* tc, const float* mask, const int* sched, int B, int d,
    int n_pad, int k, int tile, int cmax, int kc_pad, int units, int is_bf16,
    int wgmma, int words, int* stats, float* part_d, int* part_i, int* gate,
    float* out_d, int* out_i, void* stream) {
  using namespace pqv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || cmax < 1 || units < 1 || words < 0 ||
      words > kTableWordsMax || (words > 0 && 32 * words < cmax) || tile < 1 ||
      n_pad % tile)
    return (int)cudaErrorInvalidValue;
  const ProbeSource src = {nullptr, mask, tc, B, cmax, kc_pad, stats};
  int rc;
  if (wgmma) {
    if (!is_bf16 || d % 8 || ((uintptr_t)q | (uintptr_t)emb) % 16)
      return (int)cudaErrorInvalidValue;
    rc = launch_stream_masked<MmaTile, kTopkMmaStages>(
        q, emb, emb_sq, lcl, src, sched, part_d, part_i, gate, d, k, tile, words, units, st);
  } else if (is_bf16) {  // the fp32 patch: 64 queries a block whatever the batch, as K4
    rc = launch_stream_masked<FmaTile<__nv_bfloat16, 4>, kTopkFmaStages>(
        q, emb, emb_sq, lcl, src, sched, part_d, part_i, gate, d, k, tile, words, units, st);
  } else {
    rc = launch_stream_masked<FmaTile<float, 4>, kTopkFmaStages>(
        q, emb, emb_sq, lcl, src, sched, part_d, part_i, gate, d, k, tile, words, units, st);
  }
  if (rc != 0) return rc;
  return merge(part_d, part_i, units, B, k, out_d, out_i, st);
}

// Dynamic shared memory of K3's launch, for the wrapper's own reckoning.
extern "C" int pqv_stream_masked_topk_smem(int wgmma, int block_queries, int k,
                                           int words) {
  using namespace pqv;
  if (wgmma) return masked_lists_smem<MmaTile, kTopkMmaStages>(k, words);
  return block_queries > 64 ? masked_lists_smem<FmaTile<float, 8>, kTopkFmaStages>(k, words)
                            : masked_lists_smem<FmaTile<float, 4>, kTopkFmaStages>(k, words);
}
