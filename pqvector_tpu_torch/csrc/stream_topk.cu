// K2 and K3: streaming threshold top-k, exact and IVF-masked.
//
// Replaces pqvector_tpu/kernels/stream_topk.py: pallas_stream_exact_topk
// (K2, _exact_kernel) and pallas_stream_masked_topk (K3, _masked_kernel).
//
// The TPU kernels carry one [B, 128] accumulator across a grid that runs in
// order. A CUDA grid has no order, so here block (u, qb) owns queries
// qb*16 .. qb*16+15 and the tiles u, u + U, u + 2U, ...; it keeps its own
// top-k lists in shared memory (common.cuh) and writes them as partials
// [U, B, k]. A second launch merges the U partial lists of each query.
// K3 reads its tiles from the device-side schedule (n_active, then the
// active tile ids), so the host never waits for the probe mask; the probe
// test is a direct lookup mask[b, tc[tile, lcl[row]]], with int32 ids.
//
// What bounds it on the H100: the score loop. Every block re-reads its rows
// once per 16 queries and scores them with CUDA-core FMAs from shared
// memory (2 shared loads per 4 FMAs), far below the tensor cores' rate; the
// insert phase is rare once the lists fill (a candidate must beat the k-th
// best). The design keeps it simple and exact: no tensor cores, TMA or
// wgmma yet. Making the score loop a wgmma tile is later work.
#include "common.cuh"

namespace pqv {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stream_exact_kernel(ScanArgs a) {
  __shared__ ScanSmem s;
  const int unit = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  init_lists(s.ld, s.li, kQB);
  __syncthreads();
  const int nt = a.n_pad / a.tile;
  for (int t = unit; t < nt; t += a.units) {
    scan_rows<T, kExact>(a, s, q0, t * a.tile, (t + 1) * a.tile, t);
  }
  write_lists(a, s, q0, unit);
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

static int merge(const ScanArgs& a, float* out_d, int* out_i,
                 cudaStream_t stream) {
  merge_partials_kernel<<<ceil_div(a.B, kWarps), kThreads, 0, stream>>>(
      a.out_d, a.out_i, a.units, a.B, a.k, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // namespace pqv

using pqv::ScanArgs;

// q [B, d] and emb [n_pad, d] in the storage dtype (bf16 when is_bf16);
// part_d/part_i [units, B, k] scratch; out_d/out_i [B, k].
extern "C" int pqv_stream_exact_topk(const void* q, const void* emb,
                                     const float* emb_sq, int B, int d,
                                     int n_pad, int k, int tile, int units,
                                     int is_bf16, float* part_d, int* part_i,
                                     float* out_d, int* out_i, void* stream) {
  ScanArgs a = {};
  a.q = q;
  a.emb = emb;
  a.emb_sq = emb_sq;
  a.out_d = part_d;
  a.out_i = part_i;
  a.B = B;
  a.d = d;
  a.n_pad = n_pad;
  a.k = k;
  a.tile = tile;
  a.units = units;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(units, pqv::ceil_div(B, pqv::kQB));
  if (is_bf16) {
    pqv::stream_exact_kernel<__nv_bfloat16><<<grid, pqv::kThreads, 0, st>>>(a);
  } else {
    pqv::stream_exact_kernel<float><<<grid, pqv::kThreads, 0, st>>>(a);
  }
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return pqv::merge(a, out_d, out_i, st);
}

// Adds lcl [n_pad] and tc [nt, cmax] int32, mask [B, kc_pad] f32 and the
// schedule sched [nt + 1] int32 (n_active, then active tile ids).
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
  return pqv::merge(a, out_d, out_i, st);
}
