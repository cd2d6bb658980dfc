// Per-query top-k lists as an epilogue of the score tile (score_tile.cuh),
// shared by K5 (exact per-tile top-k, scan_topk.cu) and K2 (streaming exact
// top-k, stream_topk.cu).
//
// The chunk's scores |x|^2 - 2 q.x go to shared memory 64 rows at a time,
// and there one thread per query marks the scores that beat its list's
// largest entry, which it keeps in registers, and puts each survivor in
// that entry's place. The lists live in dynamic shared memory sized by the
// call's k, entry-major ([k][query]) so that 32 queries' threads touch 32
// banks; they are unordered while rows are walked and are ranked under the
// (distance, id) order when they are written, so the result is what a
// stable sort gives whatever order the rows came in. A list lives as long as
// its block walks: one tile in K5, a run of tiles in K2, where the largest
// entry gates every later row.
//
// K5 finds the new largest entry by a pass over the list. K2 (STREAM), whose
// lists live across a long run, differs in three ways. A full list is kept
// as a binary max-heap, so a replacement costs log2(k) levels of two loads
// instead of k dependent compares. The blocks of a launch share one gate per
// query in device memory, the smallest k-th entry any block's full list has
// reached: a row above it is in no global top-k, so every block drops it
// unseen, whatever its own list holds. That is the TPU kernel's carried
// threshold, carried across an unordered grid by atomicMin: which rows a
// block's partial list keeps depends on timing, the merged top-k does not.
// And a block drains only the queries it really has.
#pragma once

#include "score_tile.cuh"

namespace pqv {

constexpr int kDumpStride = 65;  // floats per query of the 64-row score dump

// Thread t < NQB owns query t's list. The list is unordered while the rows
// are walked: the thread keeps the list's largest entry (under the
// (distance, id) order) and its slot in registers, a row that beats it takes
// that slot, and one pass over the k entries (independent loads) finds the
// new largest (STREAM: the list is a max-heap and the largest entry its
// root). While the list is still filling no pass is needed. The lists are
// ranked once, by the whole block, when the walk is done.
template <class Tile, bool STREAM = false>
struct TopkLists {
  static constexpr int NQB = Tile::kQueries;
  const float* emb_sq;
  float* ld;    // shared, [k][NQB]
  int* li;      // shared, [k][NQB]
  float* dump;  // shared, [NQB][kDumpStride]
  float* sqs;   // shared, [2][kTR]
  int k, row_end;
  float kd;  // the largest entry of this thread's list once it is full,
  int ki;    // (+3e38, -1) before
  int kpos, cnt;
  int* gate;  // STREAM: device memory, this block's queries' shared gates
  int nq;     // STREAM: queries this block really has

  // Floats as ints of the same order, for atomicMin on a gate.
  static __device__ __forceinline__ int gate_key(float f) {
    const int i = __float_as_int(f);
    return i >= 0 ? i : i ^ 0x7fffffff;
  }
  static __device__ __forceinline__ float gate_value(int key) {
    return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
  }

  // Lay the lists, the dump and the norms out at `mem` (the end of the ring)
  // and empty every list. A barrier of the walk precedes their first use.
  __device__ __forceinline__ void attach(char* mem, const float* norms, int k_) {
    emb_sq = norms;
    ld = reinterpret_cast<float*>(mem);
    li = reinterpret_cast<int*>(ld + NQB * k_);
    dump = reinterpret_cast<float*>(li + NQB * k_);
    sqs = dump + NQB * kDumpStride;
    k = k_;
    kd = kPosInf;
    ki = -1;
    kpos = cnt = 0;
    for (int e = threadIdx.x; e < NQB * k_; e += kThreads) {
      ld[e] = kPosInf;
      li[e] = -1;
    }
  }

  __device__ __forceinline__ void begin(int r0, int slot) {
    if (threadIdx.x < kTR) {
      const int row = r0 + threadIdx.x;
      sqs[slot * kTR + threadIdx.x] = row < row_end ? emb_sq[row] : kPosInf;
    }
  }

  // STREAM: put (v, id) into the subtree at slot j, whose two child subtrees
  // are max-heaps under the (distance, id) order (children of j: 2j + 1 and
  // 2j + 2). Slots of one query are NQB words apart, so the 32 queries of a
  // warp touch 32 banks whatever their slots.
  __device__ __forceinline__ void sift(int qq, int j, float v, int id) {
    for (;;) {
      int c = 2 * j + 1;
      if (c >= k) break;
      float cd = ld[c * NQB + qq];
      int ci = li[c * NQB + qq];
      if (c + 1 < k) {
        const float d2 = ld[(c + 1) * NQB + qq];
        const int i2 = li[(c + 1) * NQB + qq];
        const bool right = (cd < d2) | ((cd == d2) & (ci < i2));
        cd = right ? d2 : cd;
        ci = right ? i2 : ci;
        c += right;
      }
      if (!lex_less(v, id, cd, ci)) break;  // no smaller than the larger child
      ld[j * NQB + qq] = cd;
      li[j * NQB + qq] = ci;
      j = c;
    }
    ld[j * NQB + qq] = v;
    li[j * NQB + qq] = id;
  }

  // Offer rows id0 .. id0 + 63 to query qq's list. The rows that beat the
  // list's largest entry as it stands are marked first, in one pass without
  // branches; only those are looked at again, so a warp's 32 queries run as
  // many steps as the one with the most survivors, not as their sum.
  __device__ __forceinline__ void drain(int qq, int id0) {
    const float* col = dump + qq * kDumpStride;
    unsigned long long mask = 0;
    float g = 0.f;
    if constexpr (STREAM) g = gate_value(*(volatile int*)(gate + qq));
#pragma unroll 8
    for (int c = 0; c < 64; ++c) {
      const float v = col[c];
      bool in = (v < kd) | ((v == kd) & (id0 + c < ki));
      if constexpr (STREAM) in &= v <= g;
      mask |= (unsigned long long)in << c;
    }
    while (mask) {
      const int c = __ffsll((long long)mask) - 1;
      mask &= mask - 1;
      const float v = col[c];
      const int id = id0 + c;
      if (!lex_less(v, id, kd, ki)) continue;
      if constexpr (STREAM) {
        if (cnt < k) {  // still filling: (+3e38, -1) stands until the last slot
          ld[cnt * NQB + qq] = v;
          li[cnt * NQB + qq] = id;
          if (++cnt < k) continue;
          for (int j = k / 2 - 1; j >= 0; --j)  // the list is full: make it a heap
            sift(qq, j, ld[j * NQB + qq], li[j * NQB + qq]);
        } else {
          sift(qq, 0, v, id);  // in the root's place
        }
        kd = ld[qq];
        ki = li[qq];
        continue;
      }
      const int slot = cnt < k ? cnt : kpos;
      ld[slot * NQB + qq] = v;
      li[slot * NQB + qq] = id;
      if (cnt < k && ++cnt < k) continue;  // still filling: (+3e38, -1) stands
      kd = ld[qq];
      ki = li[qq];
      kpos = 0;
      for (int j = 1; j < k; ++j) {
        const float d = ld[j * NQB + qq];
        const int i = li[j * NQB + qq];
        const bool up = (kd < d) | ((kd == d) & (ki < i));  // no branches
        kd = up ? d : kd;
        ki = up ? i : ki;
        kpos = up ? j : kpos;
      }
    }
    if constexpr (STREAM) {
      if (cnt == k && kd < g) atomicMin(gate + qq, gate_key(kd));
    }
  }

  __device__ __forceinline__ void chunk(const Tile& t, int r0, int slot) {
    const float* sq = sqs + slot * kTR;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (r0 + 64 * p >= row_end) break;  // uniform
#pragma unroll
      for (int g = 0; g < Tile::kGroups; ++g) {
        if (Tile::half_of(g) != p) continue;
#pragma unroll
        for (int l = 0; l < Tile::kRun; ++l) {
          const int r = t.row_base(g) + l;
          const float s = sq[r];
#pragma unroll
          for (int jq = 0; jq < Tile::kPerThread; ++jq)
            dump[t.query(jq) * kDumpStride + r - 64 * p] =
                __fmaf_rn(-2.f, t.value(g, l, jq), s);
        }
      }
      __syncthreads();
      if (threadIdx.x < (STREAM ? nq : NQB)) drain(threadIdx.x, r0 + 64 * p);
      __syncthreads();
    }
  }

  // Write the lists to out[unit, q0 .., :k], each entry at its rank under the
  // (distance, id) order; equal entries (empty slots) keep their slot order.
  __device__ __forceinline__ void write(float* out_d, int* out_i, int unit, int q0,
                                        int B) const {
    for (int e = threadIdx.x; e < NQB * k; e += kThreads) {
      const int qq = e % NQB, j = e / NQB;
      if (q0 + qq >= B) continue;
      const float d = ld[e];
      const int i = li[e];
      int rank = 0;
      for (int o = 0; o < k; ++o) {
        const float od = ld[o * NQB + qq];
        const int oi = li[o * NQB + qq];
        rank += (od < d) | ((od == d) & ((oi < i) | ((oi == i) & (o < j))));
      }
      const size_t at = ((size_t)unit * B + q0 + qq) * k + rank;
      out_d[at] = d;
      out_i[at] = i;
    }
  }
};

// Dynamic shared memory of a launch whose epilogue is TopkLists: the
// alignment slack, the ring, the lists, the dump and the norms.
template <class Tile, int STAGES>
constexpr int topk_lists_smem(int k) {
  return 1024 + STAGES * Tile::kStageBytes + Tile::kQueries * (8 * k + 4 * kDumpStride) +
         2 * kTR * 4;
}

// Stages of the ring beside the lists: 3, but 2 on wgmma so that 128 lists
// of k = 128 still fit.
constexpr int kTopkFmaStages = 3, kTopkMmaStages = 2;

}  // namespace pqv
