// Shared device code of the top-k kernels for sm_90a: constants, the
// (distance, id) order and the warp-level sorted lists (warp_offer) that the
// lists of K4 (MaskedLists in topk_lists.cuh) and K3 (ItemLists in
// item_scan.cuh) use; the merge of K2's and K3's partial lists orders on
// it. Every kernel scores on the tile of score_tile.cuh.
//
// A candidate is inserted only if it beats the list's current k-th entry
// under the (distance, id) order: the running-threshold idea of the TPU
// stream kernels, with ties going to the lower row id. Pad and masked rows
// carry the +3e38 sentinel. List slots start as (+3e38, -1), so a sentinel
// candidate never beats an empty slot and never enters a list.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pqv {

constexpr float kPosInf = 3.0e38f;  // sentinel for pad and masked rows
constexpr int kMaxK = 128;          // largest k a list holds
constexpr int kThreads = 256;       // threads of a scan block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Insert (d, id) into the warp's sorted list of length k. The caller has
// checked that it beats the last entry, so its position p is below k.
__device__ __forceinline__ void warp_insert(float* ld, int* li, int k, float d,
                                            int id, int lane) {
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j) {
    const int s = lane + 32 * j;
    if (s < k && lex_less(ld[s], li[s], d, id)) ++cnt;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(kFull, cnt, off);
  const int p = cnt;
  float vd[kMaxK / 32];
  int vi[kMaxK / 32];
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j) {
    const int s = lane + 32 * j;
    if (s >= p && s < k - 1) {
      vd[j] = ld[s];
      vi[j] = li[s];
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j) {
    const int s = lane + 32 * j;
    if (s >= p && s < k - 1) {
      ld[s + 1] = vd[j];
      li[s + 1] = vi[j];
    }
  }
  if (lane == 0) {
    ld[p] = d;
    li[p] = id;
  }
  __syncwarp();
}

// Offer one candidate per lane to the warp's list; inserts run one at a time
// in lane order, each gated on the list's current k-th entry.
__device__ __forceinline__ void warp_offer(float* ld, int* li, int k, float cd,
                                           int cid, bool valid, int lane) {
  const bool want = valid && lex_less(cd, cid, ld[k - 1], li[k - 1]);
  unsigned m = __ballot_sync(kFull, want);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float d = __shfl_sync(kFull, cd, src);
    const int id = __shfl_sync(kFull, cid, src);
    if (lex_less(d, id, ld[k - 1], li[k - 1])) warp_insert(ld, li, k, d, id, lane);
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace pqv
