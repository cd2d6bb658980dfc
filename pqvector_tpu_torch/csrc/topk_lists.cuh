// Per-query top-k lists as an epilogue of the score tile (score_tile.cuh):
// TopkLists, shared by K5 (exact per-tile top-k, scan_topk.cu) and K2
// (streaming exact top-k, stream_topk.cu), and below it MaskedLists, K4's
// (masked per-tile top-k; K6's where its probe table does not fit), and
// ClusterLists, K6's (masked per-tile top-k on any layout).
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

// How K4 and K6 learn whether query b probes the rows of slot s of tile t:
// K4 from the pre-gathered local mask, and K6 from the probe mask directly:
// its rows' slots are their cluster ids.
struct ProbeSource {
  const float* lmask;  // K4: [nt, B, cmax]; null for K6
  const float* mask;   // K6: [B, kc_pad]
  int B, cmax, kc_pad;
  int* stats;          // null, or two counters: (block, tile) and (block, chunk) pairs scored
  __device__ __forceinline__ bool probed(int t, int b, int s) const {
    if (lmask != nullptr) return lmask[((size_t)t * B + b) * cmax + s] > 0.5f;
    return mask[(size_t)b * kc_pad + s] > 0.5f;
  }
};

constexpr int kTableWordsMax = 8;  // probe tables of up to 256 slots live in shared memory
constexpr int kSegmentChunks = 32;  // chunks whose picks one MaskChunks word holds

// The lists of K4 and K6 (a tile's own), fed only with the scores of (query,
// row) pairs the query probes.
//
// TABLE: before a tile's first chunk the block holds its queries' probe table
// for that tile as bits in shared memory, W words a query (`load_table`), and
// their union over the block's queries. From the union and the rows' slots it
// picks the chunks that hold a probed row (`pick_chunks`); the walk scores
// only those. `begin` stages a scored chunk's slots beside its norms and
// folds them, 32 rows a warp, into the set of slots each quarter of the chunk
// holds. `chunk` then tests, from those sets and the table alone, which of
// the block's queries probe each 64-row half: a half no query probes is not
// dumped, and a query that probes none of a half's slots is neither dumped
// nor drained. A dumped score whose (query, slot) bit is clear becomes the
// +3e38 sentinel, which never enters a list. Nothing here assumes that the
// slots of a tile are sorted, or few.
//
// Not TABLE (W words a query do not fit: cmax above 256, or k near 128 on
// wgmma; and K6, whose rows' slots are cluster ids): the same kernel reads
// the slots and the probe source from device memory, skips whole tiles only
// (K4; K6 none), and dumps and drains every half.
//
// The lists differ from TopkLists'. The rows a query probes are near it, so
// far more of them enter its list than of a full scan's rows (about
// k (1 + ln(rows / k)) per probed cluster), while few queries of a block
// have anything to drain in a half. So a list is kept sorted, query-major
// ([query][k]), and a whole warp drains one query at a time with the
// warp-level lists of common.cuh: two scores a lane, a ballot of those that
// beat the k-th entry, and each of them inserted by 32 lanes that hold k / 32
// entries each (`warp_offer`). The block's queries are dealt to its 8 warps
// in turn. Sorted lists need no ranking when they are written.
template <class Tile, bool TABLE>
struct MaskedLists {
  static constexpr int NQB = Tile::kQueries;
  const float* emb_sq;
  const int* lcl;  // [n_pad] a row's slot in its tile's table
  ProbeSource src;
  float* ld;    // shared, [NQB][k], ascending under (distance, id)
  int* li;      // shared, [NQB][k]
  float* dump;  // shared, [NQB][kDumpStride]
  float* sqs;   // shared, [2][kTR]
  int k, row_end, W, t, q0;

  // Shared memory after the norms: the union of the table over the queries
  // [kTableWordsMax] and the word of picked chunks, in 64 bytes; then, with
  // TABLE, the slots [2][kTR], the slot sets of each 32 rows of a chunk
  // [2][4][W] and the table [NQB][W].
  __device__ __forceinline__ unsigned* uni() const {
    return reinterpret_cast<unsigned*>(sqs + 2 * kTR);
  }
  __device__ __forceinline__ unsigned* picks() const { return uni() + kTableWordsMax; }
  __device__ __forceinline__ int* slots() const { return reinterpret_cast<int*>(uni() + 16); }
  __device__ __forceinline__ unsigned* wbits() const {
    return reinterpret_cast<unsigned*>(slots() + 2 * kTR);
  }
  __device__ __forceinline__ unsigned* tab() const { return wbits() + 2 * 4 * W; }

  // Lay the lists, the dump, the norms and the table out at `mem` (the end of
  // the ring), as TopkLists lays its own.
  __device__ __forceinline__ void layout(char* mem, const float* norms, int k_, int words) {
    emb_sq = norms;
    ld = reinterpret_cast<float*>(mem);
    li = reinterpret_cast<int*>(ld + NQB * k_);
    dump = reinterpret_cast<float*>(li + NQB * k_);
    sqs = dump + NQB * kDumpStride;
    k = k_;
    W = words;
  }

  // Empty every list. A barrier precedes their first use.
  __device__ __forceinline__ void clear() {
    for (int e = threadIdx.x; e < NQB * k; e += kThreads) {
      ld[e] = kPosInf;
      li[e] = -1;
    }
  }

  // Take tile `tile_`: read the block's probe table for it. -> whether any
  // of the block's queries probes any of its slots (the same in every thread).
  __device__ __forceinline__ bool load_table(int tile_) {
    t = tile_;
    if constexpr (!TABLE) {
      if (src.lmask == nullptr) return true;  // K6: every tile
      int any = 0;
      const int nq = min(NQB, src.B - q0);
      const float* m = src.lmask + ((size_t)t * src.B + q0) * src.cmax;
      for (int e = threadIdx.x; e < nq * src.cmax; e += kThreads) any |= m[e] > 0.5f;
      return __syncthreads_or(any) != 0;
    } else {
      __syncthreads();  // the last tile's walk has read its table
      if (threadIdx.x < kTableWordsMax) uni()[threadIdx.x] = 0u;
      __syncthreads();
      for (int e = threadIdx.x; e < NQB * W; e += kThreads) {
        const int b = q0 + e / W, c0 = 32 * (e % W);
        unsigned word = 0u;
        if (b < src.B) {
          const int n = min(32, src.cmax - c0);
          for (int i = 0; i < n; ++i) word |= (unsigned)src.probed(t, b, c0 + i) << i;
        }
        tab()[e] = word;
        if (word) atomicOr(uni() + e % W, word);
      }
      __syncthreads();
      unsigned any = 0u;
      for (int w = 0; w < W; ++w) any |= uni()[w];
      return any != 0u;
    }
  }

  // The chunks of rows [seg0, seg_end), at most kSegmentChunks of them, that
  // hold a row some query of the block probes, as MaskChunks' word.
  __device__ __forceinline__ uint32_t pick_chunks(int seg0, int seg_end) {
    const int nch = (seg_end - seg0 + kTR - 1) / kTR;
    if constexpr (!TABLE) return nch == 32 ? 0xffffffffu : (1u << nch) - 1u;
    if (threadIdx.x == 0) *picks() = 0u;  // a barrier has passed since its last reading
    __syncthreads();
    const int lane = threadIdx.x & 31;
    for (int base = seg0 + (threadIdx.x - lane); base < seg_end; base += kThreads) {
      const int row = base + lane;
      bool hit = false;
      if (row < seg_end) {
        const int s = lcl[row];
        hit = (uni()[s >> 5] >> (s & 31)) & 1u;
      }
      if (__any_sync(kFull, hit) && lane == 0) atomicOr(picks(), 1u << ((base - seg0) / kTR));
    }
    __syncthreads();
    return *picks();
  }

  __device__ __forceinline__ void begin(int r0, int slot) {
    if (threadIdx.x < kTR) {
      const int row = r0 + threadIdx.x;
      const bool ok = row < row_end;
      sqs[slot * kTR + threadIdx.x] = ok ? emb_sq[row] : kPosInf;
      if constexpr (TABLE) {
        const int s = ok ? lcl[row] : 0;
        slots()[slot * kTR + threadIdx.x] = s;
        unsigned* wb = wbits() + (slot * 4 + (threadIdx.x >> 5)) * W;
        for (int w = 0; w < W; ++w) {
          const unsigned bits =
              __reduce_or_sync(kFull, ok && (s >> 5) == w ? 1u << (s & 31) : 0u);
          if ((threadIdx.x & 31) == 0) wb[w] = bits;
        }
      }
    }
  }

  // Whether the words `words` (a query's table row, or the union) meet the
  // slots of half p of the chunk whose quarter sets are at wb.
  __device__ __forceinline__ bool meets(const unsigned* words, const unsigned* wb,
                                        int p) const {
    unsigned hit = 0u;
    for (int w = 0; w < W; ++w)
      hit |= words[w] & (wb[2 * p * W + w] | wb[(2 * p + 1) * W + w]);
    return hit != 0u;
  }

  // Whether query qq of the block has anything to do with half p.
  __device__ __forceinline__ bool wanted(int qq, const unsigned* wb, int p) const {
    if constexpr (TABLE) return meets(tab() + qq * W, wb, p);
    return q0 + qq < src.B;
  }

  // Offer rows id0 .. id0 + 63 of the dump to the lists: warp w takes the
  // queries w, w + 8, ... that want this half, one at a time.
  __device__ __forceinline__ void drain(const unsigned* wb, int p, int id0) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    unsigned todo = __ballot_sync(
        kFull, lane < NQB / kWarps && wanted(w + kWarps * lane, wb, p));
    while (todo) {
      const int qq = w + kWarps * (__ffs(todo) - 1);
      todo &= todo - 1;
      const float* col = dump + qq * kDumpStride;
      float* qd = ld + qq * k;
      int* qi = li + qq * k;
#pragma unroll
      for (int c0 = 0; c0 < 64; c0 += 32)
        warp_offer(qd, qi, k, col[c0 + lane], id0 + c0 + lane, true, lane);
    }
  }

  __device__ __forceinline__ void chunk(const Tile& tl, int r0, int slot) {
#ifdef PQV_PROFILE_NO_EPILOGUE  // scripts/torch_masked_epilogue_profile.py: the walk alone
    return;
#endif
    const float* sq = sqs + slot * kTR;
    const int* sl = slots() + slot * kTR;
    const unsigned* wb = wbits() + slot * 4 * W;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (r0 + 64 * p >= row_end) break;  // uniform
      if constexpr (TABLE) {
        if (!meets(uni(), wb, p)) continue;  // uniform: no query probes this half
      }
      unsigned mine = 0u;  // this thread's queries to dump
#pragma unroll
      for (int jq = 0; jq < Tile::kPerThread; ++jq)
        mine |= (unsigned)wanted(tl.query(jq), wb, p) << jq;
      if (mine) {
#pragma unroll
        for (int g = 0; g < Tile::kGroups; ++g) {
          if (Tile::half_of(g) != p) continue;
#pragma unroll
          for (int l = 0; l < Tile::kRun; ++l) {
            const int r = tl.row_base(g) + l;
            const float s = sq[r];
            int cs = 0;
            if constexpr (TABLE)
              cs = sl[r];
            else if (r0 + r < row_end)
              cs = lcl[r0 + r];
#pragma unroll
            for (int jq = 0; jq < Tile::kPerThread; ++jq) {
              if (!((mine >> jq) & 1u)) continue;
              const int qq = tl.query(jq);
              bool in;
              if constexpr (TABLE)
                in = (tab()[qq * W + (cs >> 5)] >> (cs & 31)) & 1u;
              else
                in = r0 + r < row_end && src.probed(t, q0 + qq, cs);
              dump[qq * kDumpStride + r - 64 * p] =
                  in ? __fmaf_rn(-2.f, tl.value(g, l, jq), s) : kPosInf;
            }
          }
        }
      }
      __syncthreads();
#ifndef PQV_PROFILE_NO_DRAIN  // the same script: flags, dumps and barriers, no list work
      drain(wb, p, r0 + 64 * p);
#endif
      __syncthreads();
    }
  }

  // Write the lists, sorted as they are, to out[unit, q0 .., :k].
  __device__ __forceinline__ void write(float* out_d, int* out_i, int unit, int q0_,
                                        int B) const {
    const int nq = min(NQB, B - q0_);
    const size_t at = ((size_t)unit * B + q0_) * k;
    for (int e = threadIdx.x; e < nq * k; e += kThreads) {
      out_d[at + e] = ld[e];
      out_i[at + e] = li[e];
    }
  }
};

// Walk tile t (rows t * tile .. (t + 1) * tile - 1), whose table `epi` holds,
// in segments of kSegmentChunks chunks, scoring the chunks it picks.
template <int STAGES, class Tile, bool TABLE>
__device__ __forceinline__ void walk_masked_tile(
    Tile& tl, const TileOperands<typename Tile::Storage>& op, int q0, int t, int tile,
    char* ring, MaskedLists<Tile, TABLE>& epi) {
  const int tile_end = (t + 1) * tile;
  epi.row_end = tile_end;
  int scored = 0;
  for (int seg0 = t * tile; seg0 < tile_end; seg0 += kSegmentChunks * kTR) {
    const int seg_end = min(seg0 + kSegmentChunks * kTR, tile_end);
    const MaskChunks chunks = {epi.pick_chunks(seg0, seg_end)};
    scored += __popc(chunks.mask);
    __syncthreads();  // every thread has left the last walk and read the word
    walk_chunks<STAGES>(tl, op, q0, seg0, seg_end, ring, epi, chunks);
  }
  if (epi.src.stats != nullptr && threadIdx.x == 0 && scored > 0) {
    atomicAdd(epi.src.stats, 1);
    atomicAdd(epi.src.stats + 1, scored);
  }
}

// The lists of K6 (masked per-tile top-k on any layout), fed only with the
// scores of (query, row) pairs whose row's cluster the query probes. A row's
// slot is its cluster id, and on a layout in file order a tile holds rows of
// most clusters, so a per-tile table buys nothing; the probe table is the
// block's queries' rows of the batch's probe mask, the same for every tile.
// It lives in shared memory cluster-major, as the set of the block's queries
// that probe each cluster (`qset`, NQB / 32 words a cluster: a thread finds
// the bits of its queries for a row in one word), with their union over the
// queries (`uni`, a bit a cluster) for picking chunks. The table is built
// once per block from the mask in device memory, and a block walks a run of
// tiles (u, u + U, ...), so that cost is shared by many tiles.
//
// In file order a 64-row half concerns many of a block's queries (at B =
// 256 about 50 of 128) with one or two probed rows each, so nothing is
// dumped whole. `chunk` appends each probed pair's score and row to its
// query's candidates in shared memory (a shared atomicAdd on the query's
// count gives the place), and after one barrier thread qq puts query qq's
// candidates, if it has any, into its list. The lists are sorted and
// query-major, as MaskedLists' are; a candidate that beats the k-th entry is
// inserted from the list's filled end (`cnt`), so an insert shifts only the
// entries it passes. A half none of the block's queries probes costs one
// __syncthreads_or. The order in which candidates arrive does not matter:
// a list is the k smallest under the (distance, id) order of what it was
// offered.
template <class Tile>
struct ClusterLists {
  static constexpr int NQB = Tile::kQueries;
  static constexpr int QW = NQB / 32;  // words of a cluster's query set
  static_assert(Tile::kGroups * Tile::kRun * Tile::kPerThread <= 128,
                "a half's pairs of a thread fit one 64-bit word");
  const float* emb_sq;
  const int* rcl;   // [n_pad] a row's cluster, kc on pad rows
  float* ld;        // shared, [NQB][k], ascending under (distance, id)
  int* li;          // shared, [NQB][k]
  float* cv;        // shared, [NQB][kDumpStride]: the half's candidates' scores
  float* sqs;       // shared, [2][kTR]: the norms of this chunk and the next
  int* cls;         // shared, [2][kTR]: their clusters (-1 past the tile)
  int* ncand;       // shared, [NQB]: each query's candidates in the half
  int* cnt;         // shared, [NQB]: the filled entries of each list
  unsigned* picks;  // shared, the word of picked chunks
  unsigned* uni;    // shared, [kc_pad / 32]: clusters some query of the block probes
  unsigned* qset;   // shared, [kc_pad][QW]: the block's queries that probe a cluster
  uint8_t* crow;    // shared, [NQB][64]: the candidates' rows within the half
  int k, kc_pad, row_end;

  // Lay everything out at `mem` (the end of the ring), as TopkLists lays its own.
  __device__ __forceinline__ void layout(char* mem, const float* norms, int k_, int kc_pad_) {
    emb_sq = norms;
    k = k_;
    kc_pad = kc_pad_;
    ld = reinterpret_cast<float*>(mem);
    li = reinterpret_cast<int*>(ld + NQB * k);
    cv = reinterpret_cast<float*>(li + NQB * k);
    sqs = cv + NQB * kDumpStride;
    cls = reinterpret_cast<int*>(sqs + 2 * kTR);
    ncand = cls + 2 * kTR;
    cnt = ncand + NQB;
    picks = reinterpret_cast<unsigned*>(cnt + NQB);
    uni = picks + 4;  // 16 bytes for the word
    qset = uni + kc_pad / 32;
    crow = reinterpret_cast<uint8_t*>(qset + kc_pad * QW);
  }

  // Build the table of queries q0 .. q0 + NQB - 1 from mask [B, kc_pad] and
  // clear the candidate counts. -> whether any of them probes any cluster.
  __device__ __forceinline__ bool load_table(const float* mask, int q0, int B) {
    for (int e = threadIdx.x; e < kc_pad * QW; e += kThreads) {
      const int w = e / kc_pad, c = e % kc_pad;  // neighbours read neighbouring clusters
      const int n = min(32, B - q0 - 32 * w);
      const float* m = mask + (size_t)(q0 + 32 * w) * kc_pad + c;
      unsigned word = 0u;
      if (n == 32) {
#pragma unroll
        for (int j = 0; j < 32; ++j) word |= (unsigned)(m[(size_t)j * kc_pad] > 0.5f) << j;
      } else {
        for (int j = 0; j < n; ++j) word |= (unsigned)(m[(size_t)j * kc_pad] > 0.5f) << j;
      }
      qset[c * QW + w] = word;
    }
    for (int e = threadIdx.x; e < NQB; e += kThreads) ncand[e] = 0;
    __syncthreads();
    int any = 0;
    for (int e = threadIdx.x; e < kc_pad / 32; e += kThreads) {
      unsigned bits = 0u;
      for (int j = 0; j < 32; ++j) {
        unsigned s = 0u;
#pragma unroll
        for (int w = 0; w < QW; ++w) s |= qset[(32 * e + j) * QW + w];
        bits |= (unsigned)(s != 0u) << j;
      }
      uni[e] = bits;
      any |= bits != 0u;
    }
    return __syncthreads_or(any) != 0;
  }

  __device__ __forceinline__ void clear() {
    for (int e = threadIdx.x; e < NQB * k; e += kThreads) {
      ld[e] = kPosInf;
      li[e] = -1;
    }
    for (int e = threadIdx.x; e < NQB; e += kThreads) cnt[e] = 0;
  }

  // The chunks of rows [seg0, seg_end), at most kSegmentChunks of them, that
  // hold a row of a cluster some query of the block probes, as MaskChunks' word.
  __device__ __forceinline__ uint32_t pick_chunks(int seg0, int seg_end) {
    if (threadIdx.x == 0) *picks = 0u;  // a barrier has passed since its last reading
    __syncthreads();
    const int lane = threadIdx.x & 31;
    for (int base = seg0 + (threadIdx.x - lane); base < seg_end; base += kThreads) {
      const int row = base + lane;
      bool hit = false;
      if (row < seg_end) {
        const int c = rcl[row];
        hit = (uni[c >> 5] >> (c & 31)) & 1u;
      }
      if (__any_sync(kFull, hit) && lane == 0) atomicOr(picks, 1u << ((base - seg0) / kTR));
    }
    __syncthreads();
    return *picks;
  }

  __device__ __forceinline__ void begin(int r0, int slot) {
    if (threadIdx.x < kTR) {
      const int row = r0 + threadIdx.x;
      const bool ok = row < row_end;
      sqs[slot * kTR + threadIdx.x] = ok ? emb_sq[row] : kPosInf;
      cls[slot * kTR + threadIdx.x] = ok ? rcl[row] : -1;
    }
  }

  // Thread qq puts query qq's candidates of rows id0 .. id0 + 63 into its
  // list and clears their count.
  __device__ __forceinline__ void drain(int id0) {
    const int qq = threadIdx.x;
    if (qq >= NQB) return;
    const int nc = ncand[qq];
    if (nc == 0) return;
    ncand[qq] = 0;
    float* qd = ld + qq * k;
    int* qi = li + qq * k;
    int n = cnt[qq];
    for (int i = 0; i < nc; ++i) {
      const float v = cv[qq * kDumpStride + i];
      const int id = id0 + crow[qq * 64 + i];
      if (!lex_less(v, id, qd[k - 1], qi[k - 1])) continue;
      int j = n < k ? n++ : k - 1;  // the first free entry, or the k-th, which drops out
      for (; j > 0 && lex_less(v, id, qd[j - 1], qi[j - 1]); --j) {
        qd[j] = qd[j - 1];
        qi[j] = qi[j - 1];
      }
      qd[j] = v;
      qi[j] = id;
    }
    cnt[qq] = n;
  }

  __device__ __forceinline__ void chunk(const Tile& tl, int r0, int slot) {
#ifdef PQV_PROFILE_NO_EPILOGUE  // scripts/torch_masked_epilogue_profile.py: the walk alone
    return;
#endif
    const float* sq = sqs + slot * kTR;
    const int* cl = cls + slot * kTR;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (r0 + 64 * p >= row_end) break;  // uniform
      // First the probe bits of every pair of the half (loads only, so they
      // overlap), then the few probed pairs' appends.
      uint64_t hits = 0;
      int i = 0;
#pragma unroll
      for (int g = 0; g < Tile::kGroups; ++g) {
        if (Tile::half_of(g) != p) continue;
#pragma unroll
        for (int l = 0; l < Tile::kRun; ++l) {
          const int c = cl[tl.row_base(g) + l];
#pragma unroll
          for (int jq = 0; jq < Tile::kPerThread; ++jq, ++i) {
            const int qq = tl.query(jq);
            const unsigned w = c >= 0 ? qset[c * QW + (qq >> 5)] : 0u;
            hits |= (uint64_t)((w >> (qq & 31)) & 1u) << i;
          }
        }
      }
      if (hits) {
        i = 0;
#pragma unroll
        for (int g = 0; g < Tile::kGroups; ++g) {
          if (Tile::half_of(g) != p) continue;
#pragma unroll
          for (int l = 0; l < Tile::kRun; ++l) {
            const int r = tl.row_base(g) + l;
#pragma unroll
            for (int jq = 0; jq < Tile::kPerThread; ++jq, ++i) {
              if (!((hits >> i) & 1u)) continue;
              const int qq = tl.query(jq);
              const int at = atomicAdd(ncand + qq, 1);
              cv[qq * kDumpStride + at] = __fmaf_rn(-2.f, tl.value(g, l, jq), sq[r]);
              crow[qq * 64 + at] = (uint8_t)(r - 64 * p);
            }
          }
        }
      }
      if (!__syncthreads_or(hits != 0)) continue;  // no query probes a row of the half
#ifndef PQV_PROFILE_NO_DRAIN  // the same script: the candidates are written, no list work
      drain(r0 + 64 * p);
#else
      if (threadIdx.x < NQB) ncand[threadIdx.x] = 0;
#endif
      __syncthreads();
    }
  }

  // Write the lists, sorted as they are, to out[unit, q0 .., :k].
  __device__ __forceinline__ void write(float* out_d, int* out_i, int unit, int q0,
                                        int B) const {
    const int nq = min(NQB, B - q0);
    const size_t at = ((size_t)unit * B + q0) * k;
    for (int e = threadIdx.x; e < nq * k; e += kThreads) {
      out_d[at + e] = ld[e];
      out_i[at + e] = li[e];
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

// ... and of one whose epilogue is MaskedLists with `words` table words a
// query: 64 bytes of flags; with a table also the slots, the quarter sets
// and the table.
template <class Tile, int STAGES>
constexpr int masked_lists_smem(int k, int words) {
  return topk_lists_smem<Tile, STAGES>(k) + 64 +
         (words > 0 ? 2 * kTR * 4 + 2 * 4 * words * 4 + Tile::kQueries * words * 4 : 0);
}

// ... and of one whose epilogue is ClusterLists over kc_pad clusters (its
// candidates' scores in the dump's place): the clusters of two chunks, two
// counts a query, the picks word, the table with its union and the
// candidates' rows.
template <class Tile, int STAGES>
constexpr int cluster_lists_smem(int k, int kc_pad) {
  return topk_lists_smem<Tile, STAGES>(k) + 2 * kTR * 4 + Tile::kQueries * 8 + 16 +
         kc_pad / 32 * 4 + kc_pad * (Tile::kQueries / 32) * 4 + Tile::kQueries * 64;
}

// Stages of the ring beside the lists: 3, but 2 on wgmma so that 128 lists
// of k = 128 still fit.
constexpr int kTopkFmaStages = 3, kTopkMmaStages = 2;

}  // namespace pqv
