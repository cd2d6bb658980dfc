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
// K3 scans by probed cluster, not by query block (item_scan.cuh). The
// clusters' rows are contiguous in the cluster-sorted layout (offsets[c] ..
// offsets[c + 1]), so three small launches turn the batch's probe ids
// [B, nprobe] into a work list on the device, with no copy to the host: a
// count of the (query, slot) pairs each cluster gets (k3_count_kernel), then
// one block (k3_plan_kernel) that scans the counts, lays the pairs out
// cluster by cluster, and writes the items (cluster, group of at most 16 of
// its queries, segment of its rows) with their row range, their pairs and
// their segment, and opens the gates. The host sizes every buffer from B,
// nprobe, the cluster count and `segs` alone. Persistent blocks of the scan
// (stream_masked_kernel) take items from the list by atomicAdd, as many as
// fit the card at once; each streams its rows once and scores them against
// only its own queries. It writes each query's list to the partial slot of
// its probe slot and segment, [nprobe * segs, B, k], and the partials are
// merged as K2's are. So a row is read once for each group of 16 queries that
// probes its cluster, not once for each 128-query block of the batch that
// probes any cluster at all. What bounds it: the bytes of the probed rows,
// then the barriers and dumps of a chunk and the first inserts of each
// item's lists; in f32 the fp32 FMAs.
#include <algorithm>

#include "item_scan.cuh"

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

// A pair p = b * nprobe + j of the probe ids belongs to its cluster, or to
// the sentinel cluster C (no rows) where its id is out of range.
__device__ __forceinline__ int cluster_of(int id, int C) {
  return (unsigned)id < (unsigned)C ? id : C;
}

// The count of pairs of each cluster, and each pair's rank among them.
__global__ void k3_count_kernel(const int* __restrict__ probe, int P, int C,
                                int* count, int* __restrict__ rank) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P; p += gridDim.x * blockDim.x)
    rank[p] = atomicAdd(count + cluster_of(probe[p], C), 1);
}

constexpr int kPlanThreads = 1024;

// The rows of cluster c (none for the sentinel) in `parts` segments of `per`
// chunks, at most `segs` and none empty, and its query groups.
struct ClusterItems {
  int begin, end, per, parts, groups;
  __device__ __forceinline__ ClusterItems(const int* offsets, int C, int c, int n, int segs) {
    begin = c < C ? offsets[c] : 0;
    end = c < C ? offsets[c + 1] : 0;
    const int chunks = (end - begin + kTR - 1) / kTR;
    const int cut = min(segs, chunks);
    per = chunks > 0 ? (chunks + cut - 1) / cut : 0;
    parts = chunks > 0 ? (chunks + per - 1) / per : 1;
    groups = (n + kItemQueries - 1) / kItemQueries;
  }
};

// Exclusive prefix sum over the block of one value a thread -> (the sum of
// the threads before this one, the block's total in `total`).
__device__ __forceinline__ long long block_scan(long long v, long long* sums,
                                                long long* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[w] = x;
  __syncthreads();
  if (w == 0) {
    long long s = sums[lane];  // kPlanThreads / 32 == 32 warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  *total = sums[31];
  return x - v + (w > 0 ? sums[w - 1] : 0);
}

// One block: the work list from the counts. Thread t owns a run of
// clusters; one scan gives each cluster the start of its pairs (low word)
// and of its items (high word). Then every pair goes to its place, the
// gates open and the list's length and cursor are set.
__global__ void __launch_bounds__(kPlanThreads)
    k3_plan_kernel(const int* __restrict__ offsets, const int* __restrict__ probe, int P,
                   int C, int B, int segs, const int* __restrict__ count,
                   const int* __restrict__ rank, int* pstart, int* __restrict__ pairs,
                   int4* __restrict__ items, int* head, int* __restrict__ gate) {
  __shared__ long long sums[32];
  const int nc = C + 1;
  const int run = (nc + kPlanThreads - 1) / kPlanThreads;
  const int c0 = min(nc, (int)threadIdx.x * run), c1 = min(nc, c0 + run);
  long long mine = 0;
  for (int c = c0; c < c1; ++c) {
    const int n = count[c];
    if (n > 0) {
      const ClusterItems ci(offsets, C, c, n, segs);
      mine += (long long)ci.groups * ci.parts << 32;
    }
    mine += n;  // the pairs, at most 2^31 - 1 in all: no carry into the items
  }
  long long total;
  const long long at = block_scan(mine, sums, &total);
  int pa = (int)(at & 0xffffffffll), ia = (int)(at >> 32);
  for (int c = c0; c < c1; ++c) {
    const int n = count[c];
    pstart[c] = pa;
    if (n > 0) {
      const ClusterItems ci(offsets, C, c, n, segs);
      for (int g = 0; g < ci.groups; ++g) {
        const int nq = min(kItemQueries, n - g * kItemQueries);
        for (int s = 0; s < ci.parts; ++s) {
          const int rb = min(ci.end, ci.begin + s * ci.per * kTR);
          const int re = min(ci.end, ci.begin + (s + 1) * ci.per * kTR);
          items[ia++] = make_int4(rb, re, pa + g * kItemQueries,
                                  nq | (s << 8) | (ci.parts << 16));
        }
      }
    }
    pa += n;
  }
  if (threadIdx.x == 0) {
    head[0] = (int)(total >> 32);
    head[1] = 0;
  }
  __syncthreads();  // every cluster's start is written
  for (int p = threadIdx.x; p < P; p += kPlanThreads)
    pairs[pstart[cluster_of(probe[p], C)] + rank[p]] = p;
  for (int b = threadIdx.x; b < B; b += kPlanThreads)
    gate[b] = 0x7f7f7f7f;  // above the +3e38 sentinel: 3.39e38
}

// The scan: each block takes items until the list is done. An item's lists
// start empty, its walk scores every row of its range against its queries,
// and its lists go to their partial slots (ItemLists::write).
template <class Tile>
__global__ void __launch_bounds__(kThreads, 3)
    stream_masked_kernel(ItemOperands<typename Tile::Storage> op,
                         const float* __restrict__ emb_sq, const int4* __restrict__ items,
                         const int* __restrict__ pairs, int* head, int B, int nprobe,
                         int segs, int k, float* __restrict__ part_d,
                         int* __restrict__ part_i, int* gate, int* stats) {
  extern __shared__ char dyn[];
  __shared__ int item;
  char* ring = align_ring(dyn);
  Tile t;
  ItemLists<Tile> epi;
  epi.layout(ring + kItemStages * Tile::kStageBytes, emb_sq, k);
  epi.gate = gate;
  op.qidx = epi.qidx;
  const int n_items = head[0];
  for (;;) {
    if (threadIdx.x == 0) item = atomicAdd(head + 1, 1);
    __syncthreads();  // the item is read; the last item's lists are written
    const int it = item;
    if (it >= n_items) break;
    const int4 w = items[it];
    const int nq = w.w & 0xff, s = (w.w >> 8) & 0xff, parts = w.w >> 16;
    if (threadIdx.x < kItemQueries) {
      const int p = threadIdx.x < nq ? pairs[w.z + threadIdx.x] : 0;
      epi.qidx[threadIdx.x] = p / nprobe;
      epi.slot[threadIdx.x] = p % nprobe * segs + s;
    }
    epi.clear();
    epi.nq = op.nq = nq;
    epi.row_end = w.y;
    __syncthreads();
    if (w.y > w.x) {
      walk_rows<kItemStages>(t, op, 0, w.x, w.y, ring, epi);
      if (stats != nullptr && threadIdx.x == 0) {
        atomicAdd(stats, 1);
        atomicAdd(stats + 1, (w.y - w.x + kTR - 1) / kTR);
      }
    }
    __syncthreads();  // the lists are complete
    epi.write(part_d, part_i, B, s == parts - 1 ? segs - parts : 0);
  }
}

// The largest work list of C clusters, P pairs and `segs` segments: a
// cluster with n pairs has ceil(n / 16) groups, so all of them have at most
// ceil(P / 16) + (clusters with a pair) groups, each in at most segs items.
static int k3_max_items(int C, int P, int segs) {
  return segs * (ceil_div(P, kItemQueries) + std::min(C + 1, P));
}

// K3's scratch, in int32 words: the items (int4, first, so 16-byte aligned),
// the list's length and cursor (4 words), the counts and pair starts of the
// clusters and the sentinel, each pair's rank, and the pairs by cluster.
static long long k3_scratch_words(int C, int P, int segs) {
  return 4ll * k3_max_items(C, P, segs) + 4 + 2ll * (C + 1) + 2ll * P;
}

template <class Tile>
int launch_item_scan(const void* q, const void* emb, const float* emb_sq, const int4* items,
                     const int* pairs, int* head, int B, int d, int k, int nprobe, int segs,
                     int max_items, float* part_d, int* part_i, int* gate, int* stats,
                     cudaStream_t st) {
  using T = typename Tile::Storage;
  auto kernel = stream_masked_kernel<Tile>;
  const int smem = item_scan_smem<Tile>(k);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::max(1, std::min(max_items, sms * std::max(1, per_sm)));
  ItemOperands<T> op = {static_cast<const T*>(q), static_cast<const T*>(emb), nullptr, 0, d};
  kernel<<<grid, kThreads, smem, st>>>(op, emb_sq, items, pairs, head, B, nprobe, segs, k,
                                       part_d, part_i, gate, stats);
  return (int)cudaGetLastError();
}

// One warp per query: fold the [U, B, k] partial lists, each ascending
// under the (distance, id) order, into [B, k], one partial list at a time.
// The lanes first read the heads of 32 lists at once; only a list whose
// head beats the running k-th entry can add anything, and the running k-th
// only falls, so the others are never read in full. A list that passes is
// loaded into shared memory beside the running list; each entry's place in
// their union is its own index plus its rank in the other list (a binary
// search: an entry of the running list goes before an equal one of the
// next, so every place is taken once), and the places below k are kept.
// So a query costs U / 32 head reads and one binary-search pass a list that
// adds something, not one insert a candidate that beats the running k-th
// entry (some hundreds at k = 100).
__global__ void __launch_bounds__(kThreads)
    merge_partials_kernel(const float* __restrict__ pd, const int* __restrict__ pi, int units,
                          int B, int k, float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float ld[kWarps][3][kMaxK];
  __shared__ int li[kWarps][3][kMaxK];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + w;
  if (b >= B) return;  // whole warp leaves; no block barrier follows
  float* const qd = ld[w][1];  // the list being folded in
  int* const qi = li[w][1];
  int run = 0, spare = 2;
  for (int s = lane; s < k; s += 32) {
    ld[w][run][s] = pd[(size_t)b * k + s];
    li[w][run][s] = pi[(size_t)b * k + s];
  }
  __syncwarp();
  for (int u0 = 1; u0 < units; u0 += 32) {
    const int u = u0 + lane;
    float head_d = kPosInf;
    int head_i = -1;
    if (u < units) {
      head_d = pd[((size_t)u * B + b) * k];
      head_i = pi[((size_t)u * B + b) * k];
    }
    unsigned todo = __ballot_sync(
        kFull, u < units && lex_less(head_d, head_i, ld[w][run][k - 1], li[w][run][k - 1]));
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const float* ad = ld[w][run];
      const int* ai = li[w][run];
      const float jd = __shfl_sync(kFull, head_d, j);
      const int ji = __shfl_sync(kFull, head_i, j);
      if (!lex_less(jd, ji, ad[k - 1], ai[k - 1])) continue;  // the k-th fell below it
      const size_t o = ((size_t)(u0 + j) * B + b) * k;
      for (int s = lane; s < k; s += 32) {
        qd[s] = pd[o + s];
        qi[s] = pi[o + s];
      }
      __syncwarp();
      float* od = ld[w][spare];
      int* oi = li[w][spare];
      for (int s = lane; s < k; s += 32) {
        float d = ad[s];
        int id = ai[s];
        int lo = 0, hi = k - s;  // entries of the next list below (d, id), up to k - s
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (lex_less(qd[mid], qi[mid], d, id)) lo = mid + 1; else hi = mid;
        }
        if (s + lo < k) {
          od[s + lo] = d;
          oi[s + lo] = id;
        }
        d = qd[s];
        id = qi[s];
        lo = 0;
        hi = k - s;  // entries of the running list at or below (d, id)
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (!lex_less(d, id, ad[mid], ai[mid])) lo = mid + 1; else hi = mid;
        }
        if (s + lo < k) {
          od[s + lo] = d;
          oi[s + lo] = id;
        }
      }
      const int t = run;
      run = spare;
      spare = t;
      __syncwarp();  // every lane is done with the lists before the next is stored
    }
  }
  for (int s = lane; s < k; s += 32) {
    out_d[(size_t)b * k + s] = ld[w][run][s];
    out_i[(size_t)b * k + s] = li[w][run][s];
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

// K3: q, emb and emb_sq as for K2; offsets [C + 1] int32, the first row of
// each cluster in the cluster-sorted layout and the end of the last; probe
// [B, nprobe] int32 cluster ids (ids out of range probe nothing); a cluster's
// rows are cut into at most segs segments; scratch of
// pqv_stream_masked_topk_scratch int32 words; part_d/part_i
// [nprobe * segs, B, k] and gate [B] int32 scratch. wgmma as for K2; stats
// is null or two int32 counters the launch adds the work items it scored
// (those with rows) and their (item, chunk) pairs to.
extern "C" int pqv_stream_masked_topk(
    const void* q, const void* emb, const float* emb_sq, const int* offsets,
    const int* probe, int B, int d, int k, int n_clusters, int nprobe, int segs,
    int is_bf16, int wgmma, int* stats, int* scratch, float* part_d, int* part_i,
    int* gate, float* out_d, int* out_i, void* stream) {
  using namespace pqv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || B < 1 || n_clusters < 1 || nprobe < 1 || segs < 1 ||
      segs > 255 || (long long)B * nprobe > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  if (wgmma && (!is_bf16 || d % 8 || ((uintptr_t)q | (uintptr_t)emb) % 16))
    return (int)cudaErrorInvalidValue;
  const int C = n_clusters, P = B * nprobe;
  const int max_items = k3_max_items(C, P, segs);
  int4* items = reinterpret_cast<int4*>(scratch);
  int* head = scratch + 4ll * max_items;
  int* count = head + 4;
  int* pstart = count + (C + 1);
  int* rank = pstart + (C + 1);
  int* pairs = rank + P;
  cudaError_t err = cudaMemsetAsync(count, 0, (size_t)(C + 1) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  k3_count_kernel<<<std::min(ceil_div(P, kThreads), 264), kThreads, 0, st>>>(probe, P, C,
                                                                           count, rank);
  k3_plan_kernel<<<1, kPlanThreads, 0, st>>>(offsets, probe, P, C, B, segs, count, rank,
                                             pstart, pairs, items, head, gate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int rc;
  if (wgmma) {
    rc = launch_item_scan<ItemMmaTile>(q, emb, emb_sq, items, pairs, head, B, d, k, nprobe,
                                       segs, max_items, part_d, part_i, gate, stats, st);
  } else if (is_bf16) {
    rc = launch_item_scan<ItemFmaTile<__nv_bfloat16>>(q, emb, emb_sq, items, pairs, head, B,
                                                      d, k, nprobe, segs, max_items, part_d,
                                                      part_i, gate, stats, st);
  } else {
    rc = launch_item_scan<ItemFmaTile<float>>(q, emb, emb_sq, items, pairs, head, B, d, k,
                                              nprobe, segs, max_items, part_d, part_i, gate,
                                              stats, st);
  }
  if (rc != 0) return rc;
  return merge(part_d, part_i, nprobe * segs, B, k, out_d, out_i, st);
}

// K3's scratch in int32 words for n_clusters clusters, `pairs` (B * nprobe)
// probe ids and segs segments, for the wrapper's allocation; -1 where that
// passes 2^31 - 1.
extern "C" int pqv_stream_masked_topk_scratch(int n_clusters, int pairs, int segs) {
  const long long words = pqv::k3_scratch_words(n_clusters, pairs, segs);
  return words > 0x7fffffffll ? -1 : (int)words;
}

// Dynamic shared memory of K3's scan, for the wrapper's own reckoning.
extern "C" int pqv_stream_masked_topk_smem(int wgmma, int k) {
  using namespace pqv;
  return wgmma ? item_scan_smem<ItemMmaTile>(k) : item_scan_smem<ItemFmaTile<float>>(k);
}
