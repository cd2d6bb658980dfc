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
// K3 still runs the scan block of common.cuh: block (u, qb) owns queries
// qb*16 .. qb*16+15 and the active tiles u, u + U, ...; it reads its tiles
// from the device-side schedule (n_active, then the active tile ids), so the
// host never waits for the probe mask; the probe test is a direct lookup
// mask[b, tc[tile, lcl[row]]], with int32 ids. Its CUDA-core score loop (one
// row x 4 queries a thread, 2 shared loads per 4 FMAs) bounds it; it can
// take the score tile as K2 did.
#include "topk_lists.cuh"

namespace pqv {

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
  // Every gate starts above the +3e38 sentinel: 0x7f7f7f7f is 3.39e38.
  err = cudaMemsetAsync(gate, 0x7f, (size_t)B * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int nqb = ceil_div(B, Tile::kQueries);
  kernel<<<ceil_div(n_pad, run) * nqb, kThreads, smem, st>>>(op, emb_sq, part_d, part_i,
                                                              gate, k, n_pad, run, nqb);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stream_masked_kernel(ScanArgs a) {
  __shared__ ScanSmem s;
  const int unit = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  init_lists(s.ld, s.li, kQB);
  __syncthreads();
  const int n_active = a.sched[0];
  for (int i = unit; i < n_active; i += a.units) {
    const int t = a.sched[1 + i];
    scan_rows<T, kMaskTable>(a, s, q0, t * a.tile, (t + 1) * a.tile, t);
  }
  write_lists(a, s, q0, unit);
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

using pqv::ScanArgs;

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
// active tile ids); part_d/part_i [units, B, k] scratch.
extern "C" int pqv_stream_masked_topk(
    const void* q, const void* emb, const float* emb_sq, const int* lcl,
    const int* tc, const float* mask, const int* sched, int B, int d,
    int n_pad, int k, int tile, int cmax, int kc_pad, int units, int is_bf16,
    float* part_d, int* part_i, float* out_d, int* out_i, void* stream) {
  ScanArgs a = {};
  a.q = q;
  a.emb = emb;
  a.emb_sq = emb_sq;
  a.lcl = lcl;
  a.tc = tc;
  a.mask = mask;
  a.sched = sched;
  a.out_d = part_d;
  a.out_i = part_i;
  a.B = B;
  a.d = d;
  a.n_pad = n_pad;
  a.k = k;
  a.tile = tile;
  a.cmax = cmax;
  a.kc_pad = kc_pad;
  a.units = units;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(units, pqv::ceil_div(B, pqv::kQB));
  if (is_bf16) {
    pqv::stream_masked_kernel<__nv_bfloat16><<<grid, pqv::kThreads, 0, st>>>(a);
  } else {
    pqv::stream_masked_kernel<float><<<grid, pqv::kThreads, 0, st>>>(a);
  }
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return pqv::merge(part_d, part_i, units, B, k, out_d, out_i, st);
}
