// K4: masked IVF scan over a cluster-sorted layout with a local mask.
// K5: exact per-tile top-k. K6: per-tile top-k masked by a global probe mask.
//
// Replace pqvector_tpu/kernels/scan_topk.py: pallas_masked_local_topk
// (_masked_local_scan_kernel), pallas_exact_topk (_scan_kernel) and
// pallas_masked_topk (_masked_scan_kernel), with _extract_topk in each.
//
// The TPU kernel extracts each tile's top-k by k min-passes over a [B, tile]
// score block and tests the probe through a one-hot matmul of the
// pre-gathered mask lmask [nt, B, cmax]. Here block (t, qb) scores tile t
// for queries qb*16 .. qb*16+15, tests each pair by the direct lookup
// lmask[t, b, lcl[row]], and keeps a sorted top-k per query in shared
// memory (common.cuh), inserting only what beats the current k-th entry.
// It writes the per-tile winners [nt, B, k]; the cross-tile merge and the
// f32 re-score stay outside, as in the JAX package.
//
// What bounds it on the H100: as for K2/K3, the CUDA-core score loop
// (fp32 FMA from shared memory). A block first reads its queries' slice of
// lmask and skips a tile that none of them probes, so the work follows the
// union of the 16 queries' probed clusters rather than the whole matrix.
// One block per (tile, query group) gives nt * ceil(B/16) blocks, enough to
// fill the 132 SMs at the bench shape. No tensor cores, TMA or wgmma yet.
//
// K5 and K6 are the same block over every tile. K5 tests nothing; K6 looks
// up mask[b, row_cluster[row]] with int32 cluster ids (the TPU kernel ships
// them as f32 and tests them through a one-hot matmul, a Mosaic
// workaround). Pad rows carry cluster id kc, whose mask slot is never set.
// On a layout in file order a tile holds rows of most clusters, so K6
// cannot skip tiles as K4 does; it skips a 64-row chunk that none of its
// 16 queries probes, which pays at small batches. Both are bound by the
// same CUDA-core score loop as K4, over all n_pad rows.
#include "common.cuh"

namespace pqv {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    masked_local_kernel(ScanArgs a) {
  __shared__ ScanSmem s;
  __shared__ int probed;
  const int t = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  init_lists(s.ld, s.li, kQB);
  if (threadIdx.x == 0) probed = 0;
  __syncthreads();
  // A tile that none of the block's queries probes adds nothing: skip it.
  for (int e = threadIdx.x; e < kQB * a.cmax; e += blockDim.x) {
    const int b = q0 + e / a.cmax;
    if (b < a.B && a.lmask[((size_t)t * a.B + b) * a.cmax + e % a.cmax] > 0.5f)
      probed = 1;
  }
  __syncthreads();
  if (probed) scan_rows<T, kLocalMask>(a, s, q0, t * a.tile, (t + 1) * a.tile, t);
  write_lists(a, s, q0, t);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) tile_topk_kernel(ScanArgs a) {
  __shared__ ScanSmem s;
  const int t = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  init_lists(s.ld, s.li, kQB);
  __syncthreads();
  scan_rows<T, MODE>(a, s, q0, t * a.tile, (t + 1) * a.tile, t);
  write_lists(a, s, q0, t);
}

template <int MODE>
int launch_tile_topk(const ScanArgs& a, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(a.n_pad / a.tile, ceil_div(a.B, kQB));
  if (is_bf16) {
    tile_topk_kernel<__nv_bfloat16, MODE><<<grid, kThreads, 0, st>>>(a);
  } else {
    tile_topk_kernel<float, MODE><<<grid, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace pqv

// K5: q [B, d] and emb [n_pad, d] in the storage dtype; out [nt, B, k].
extern "C" int pqv_exact_topk(const void* q, const void* emb, const float* emb_sq,
                              int B, int d, int n_pad, int k, int tile,
                              int is_bf16, float* out_d, int* out_i,
                              void* stream) {
  pqv::ScanArgs a = {};
  a.q = q;
  a.emb = emb;
  a.emb_sq = emb_sq;
  a.out_d = out_d;
  a.out_i = out_i;
  a.B = B;
  a.d = d;
  a.n_pad = n_pad;
  a.k = k;
  a.tile = tile;
  a.units = n_pad / tile;
  return pqv::launch_tile_topk<pqv::kExact>(a, is_bf16, stream);
}

// K6: adds row_cluster [n_pad] int32 (kc on pad rows) and the probe mask
// [B, kc_pad] f32; out [nt, B, k].
extern "C" int pqv_masked_topk(const void* q, const void* emb, const float* emb_sq,
                               const int* row_cluster, const float* mask, int B,
                               int d, int n_pad, int k, int tile, int kc_pad,
                               int is_bf16, float* out_d, int* out_i,
                               void* stream) {
  pqv::ScanArgs a = {};
  a.q = q;
  a.emb = emb;
  a.emb_sq = emb_sq;
  a.rcl = row_cluster;
  a.mask = mask;
  a.out_d = out_d;
  a.out_i = out_i;
  a.B = B;
  a.d = d;
  a.n_pad = n_pad;
  a.k = k;
  a.tile = tile;
  a.kc_pad = kc_pad;
  a.units = n_pad / tile;
  return pqv::launch_tile_topk<pqv::kRowMask>(a, is_bf16, stream);
}

// K4: q [B, d] and emb [n_pad, d] in the storage dtype (bf16 when is_bf16);
// lcl [n_pad] int32, lmask [nt, B, cmax] f32; out [nt, B, k].
extern "C" int pqv_masked_local_topk(const void* q, const void* emb,
                                     const float* emb_sq, const int* lcl,
                                     const float* lmask, int B, int d,
                                     int n_pad, int k, int tile, int cmax,
                                     int is_bf16, float* out_d, int* out_i,
                                     void* stream) {
  pqv::ScanArgs a = {};
  a.q = q;
  a.emb = emb;
  a.emb_sq = emb_sq;
  a.lcl = lcl;
  a.lmask = lmask;
  a.out_d = out_d;
  a.out_i = out_i;
  a.B = B;
  a.d = d;
  a.n_pad = n_pad;
  a.k = k;
  a.tile = tile;
  a.cmax = cmax;
  const int nt = n_pad / tile;
  a.units = nt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(nt, pqv::ceil_div(B, pqv::kQB));
  if (is_bf16) {
    pqv::masked_local_kernel<__nv_bfloat16><<<grid, pqv::kThreads, 0, st>>>(a);
  } else {
    pqv::masked_local_kernel<float><<<grid, pqv::kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
