// Shared device code of the top-k scan kernels for sm_90a: constants, the
// (distance, id) order and the warp-level sorted lists (warp_offer) that
// K6, K3's and K4's lists (topk_lists.cuh) and the merge of K2's and K3's
// partial lists use, and scan_rows, the CUDA-core scan block that K6 (masked
// per-tile, any layout) still runs. K1 to K5 and K9 score on the tile of
// score_tile.cuh instead.
//
// One block owns kQB queries and walks a set of row ranges. For each chunk
// of kRC rows it scores every (query, row) pair in IEEE fp32 FMA (bf16
// storage is widened to fp32 on load, so bf16 x bf16 products are exact and
// only the accumulation rounds), writes the partial distances
// |x|^2 - 2 q.x to shared memory, and then one warp per query offers them to
// that query's sorted top-k list, also in shared memory. A candidate is
// inserted only if it beats the list's current k-th entry under the
// (distance, id) order: the running-threshold idea of the TPU stream
// kernels, with ties going to the lower row id.
//
// Pad and masked rows carry the +3e38 sentinel. List slots start as
// (+3e38, -1), so a sentinel candidate never beats an empty slot and never
// enters a list.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pqv {

constexpr float kPosInf = 3.0e38f;  // sentinel for pad and masked rows
constexpr int kMaxK = 128;          // largest k a list holds
constexpr int kThreads = 256;       // threads of a scan block
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 16;             // queries per scan block
constexpr int kRC = 64;             // rows per scored chunk
constexpr int kDK = 64;             // dimensions staged per step
constexpr unsigned kFull = 0xffffffffu;

static_assert(kQB * kRC == 4 * kThreads, "each thread scores 4 pairs");

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

// What K6's scan block takes. A (query, row) pair is probed when
// mask[b, rcl[row]] is set.
struct ScanArgs {
  const void* q;         // [B, d] in the storage dtype
  const void* emb;       // [n_pad, d]
  const float* emb_sq;   // [n_pad], +3e38 on pad rows
  const int* rcl;        // [n_pad] row's cluster id, kc on pad rows
  const float* mask;     // [B, kc_pad] probe mask
  float* out_d;          // [nt, B, k]
  int* out_i;            // [nt, B, k]
  int B, d, n_pad, k, tile, kc_pad;
};

struct __align__(16) ScanSmem {
  float x[kRC][kDK + 1];  // +1 column: rows land in distinct banks
  float qT[kDK][kQB];     // transposed so 4 queries are one float4 load
  float part[kQB][kRC];
  float ld[kQB][kMaxK];
  int li[kQB][kMaxK];
};

__device__ __forceinline__ void init_lists(float (*ld)[kMaxK], int (*li)[kMaxK],
                                           int nq) {
  for (int e = threadIdx.x; e < nq * kMaxK; e += blockDim.x) {
    ld[e / kMaxK][e % kMaxK] = kPosInf;
    li[e / kMaxK][e % kMaxK] = -1;
  }
}

// Score rows [row_begin, row_end) against the block's queries q0 .. q0 + kQB - 1
// and merge the probed ones into the lists.
template <typename T>
__device__ void scan_rows(const ScanArgs& a, ScanSmem& s, int q0, int row_begin,
                          int row_end) {
  const T* q = static_cast<const T*>(a.q);
  const T* emb = static_cast<const T*>(a.emb);
  const int t = threadIdx.x;
  const int r = t % kRC;  // row of the chunk this thread scores
  const int g = t / kRC;  // its queries: 4g .. 4g + 3
  const int lane = t & 31;
  const int w = t >> 5;
  for (int r0 = row_begin; r0 < row_end; r0 += kRC) {
    // On a layout in file order a chunk's rows span many clusters; skip a
    // chunk that none of the block's queries probes (common at small B).
    int any = 0;
    for (int e = t; e < kQB * kRC; e += kThreads) {
      const int b = q0 + e / kRC, row = r0 + e % kRC;
      if (b < a.B && row < row_end && a.mask[(size_t)b * a.kc_pad + a.rcl[row]] > 0.5f)
        any = 1;
    }
    if (!__syncthreads_or(any)) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < a.d; d0 += kDK) {
      for (int e = t; e < kRC * kDK; e += kThreads) {
        const int rr = e / kDK, cc = e % kDK;
        const int row = r0 + rr, col = d0 + cc;
        s.x[rr][cc] = (row < row_end && col < a.d)
                          ? to_f32(emb[(size_t)row * a.d + col])
                          : 0.f;
      }
      for (int e = t; e < kQB * kDK; e += kThreads) {
        const int qq = e / kDK, cc = e % kDK;
        const int b = q0 + qq, col = d0 + cc;
        s.qT[cc][qq] =
            (b < a.B && col < a.d) ? to_f32(q[(size_t)b * a.d + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < kDK; ++cc) {
        const float xv = s.x[r][cc];
        const float4 qv = *reinterpret_cast<const float4*>(&s.qT[cc][4 * g]);
        acc[0] = fmaf(xv, qv.x, acc[0]);
        acc[1] = fmaf(xv, qv.y, acc[1]);
        acc[2] = fmaf(xv, qv.z, acc[2]);
        acc[3] = fmaf(xv, qv.w, acc[3]);
      }
      __syncthreads();
    }
    const int row = r0 + r;
    const bool row_ok = row < row_end;
    const float sq = row_ok ? a.emb_sq[row] : kPosInf;
    const int slot = row_ok ? a.rcl[row] : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qq = 4 * g + j;
      const int b = q0 + qq;
      float v = sq - 2.f * acc[j];
      if (!row_ok || b >= a.B || !(a.mask[(size_t)b * a.kc_pad + slot] > 0.5f))
        v = kPosInf;
      s.part[qq][r] = v;
    }
    __syncthreads();
    for (int qq = w; qq < kQB; qq += kWarps) {
      if (q0 + qq >= a.B) continue;  // uniform across the warp
      for (int c0 = 0; c0 < kRC; c0 += 32) {
        warp_offer(s.ld[qq], s.li[qq], a.k, s.part[qq][c0 + lane],
                   r0 + c0 + lane, true, lane);
      }
    }
    __syncthreads();
  }
}

// Write the block's lists to out[unit, q0 .. q0 + kQB - 1, :k].
__device__ __forceinline__ void write_lists(const ScanArgs& a, const ScanSmem& s,
                                            int q0, int unit) {
  for (int e = threadIdx.x; e < kQB * a.k; e += blockDim.x) {
    const int qq = e / a.k, j = e % a.k;
    const int b = q0 + qq;
    if (b >= a.B) continue;
    const size_t o = ((size_t)unit * a.B + b) * a.k + j;
    a.out_d[o] = s.ld[qq][j];
    a.out_i[o] = s.li[qq][j];
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace pqv
