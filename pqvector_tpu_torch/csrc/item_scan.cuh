// K3's scan by work items (stream_topk.cu): the score tiles and the lists of
// one item, the rows of a probed cluster (or of one segment of them) against
// the at most kItemQueries queries of the batch that probe that cluster.
//
// A cluster's rows are contiguous in the cluster-sorted layout, and every
// query of an item probes every one of them, so an item needs no probe table,
// no per-row test and no per-query gate: its walk streams the rows once, in
// 128-row chunks through the ring of score_tile.cuh (walk_rows), and each
// chunk's scores go to its queries' lists. The queries are few (at B = 4096,
// nprobe 4 over 4,096 clusters about 4 an item), so the tiles put the rows on
// the wide side and the queries on the narrow one:
//
// ItemMmaTile, bf16 on wgmma: each warpgroup runs m64n16k16 with 64 of the
//   chunk's rows as M and the item's 16 query slots as N, both K-major under
//   the 128-byte swizzle, as MmaTile stages them with the roles swapped. A
//   stage holds 64 dimensions of the 128 rows (16 KB) and of the 16 queries
//   (2 KB, gathered by their batch rows). A thread holds 2 rows x 4 queries.
//   The products are exact and each sum is the tensor cores' fp32 sum of
//   them, as in MmaTile.
// ItemFmaTile, IEEE fp32 on the CUDA cores (f32 storage, and bf16 that the
//   tensor cores cannot take, widened on the way in): FmaTile's transposed
//   stages of 16 dimensions with 16 query slots; a thread holds 4 rows x 2
//   queries and adds its products in ascending dimension order with
//   __fmaf_rn from zero, so every sum is FmaTile's bit for bit.
//
// ItemLists: one sorted list of k a query slot in shared memory, ascending
// under the (distance, id) order. After a chunk's sums each thread writes its
// live queries' scores |x|^2 - 2 q.x to a dump (two of them, alternating by
// chunk, so that one barrier a chunk suffices), and warp w drains the slots
// w, w + 8 with the warp-level lists of common.cuh, gated, as K2's lists
// are, by each query's gate in device memory: the smallest k-th entry any of
// its full lists has reached, by atomicMin. A list holds only rows its query
// probes, so a row above that gate is in no top-k of the query.
#pragma once

#include "topk_lists.cuh"

namespace pqv {

constexpr int kItemQueries = 16;  // query slots of an item: the wgmma's N
constexpr int kItemStages = 3;    // stages of the ring

// What an item's walk scores: the rows of emb against the nq queries whose
// batch rows qidx (shared memory) lists.
template <typename T>
struct ItemOperands {
  const T* q;
  const T* emb;
  const int* qidx;
  int nq, d;
};

// d (+)= A[64 x 16] B[16 x 16]^T, bf16 operands from shared memory.
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

struct ItemMmaTile {
  using Storage = __nv_bfloat16;
  static constexpr int kQueries = kItemQueries;
  static constexpr int kDims = 64;
  static constexpr int kRowBytes = kTR * 128;  // the chunk's rows, then the queries
  static constexpr int kStageBytes = kRowBytes + kQueries * 128;
  static constexpr int kElems = 8;  // sums a thread holds

  float acc[8];
  int lane, r0;  // r0: the first of the thread's two rows (the other is r0 + 8)

  __device__ __forceinline__ ItemMmaTile()
      : lane(threadIdx.x & 31), r0(16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2)) {}
  // Sum e: n8 block e >> 2, row half (e >> 1) & 1, column e & 1.
  __device__ __forceinline__ int row(int e) const { return r0 + 8 * ((e >> 1) & 1); }
  __device__ __forceinline__ int query(int e) const {
    return 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
  }
  __device__ __forceinline__ float value(int e) const { return acc[e]; }

  __device__ __forceinline__ void load(char* stage, const ItemOperands<Storage>& op, int,
                                       int r0_, int row_end, int d0) const {
    const uint32_t s = smem_u32(stage);
    stage_swizzled(s, op.emb, r0_, row_end, d0, op.d);
    if (threadIdx.x < kQueries * 8) {  // a 16-byte piece of one query each
      const int qi = threadIdx.x >> 3, c = threadIdx.x & 7;
      const bool ok = qi < op.nq && d0 + 8 * c < op.d;
      const Storage* p = op.q + (size_t)op.qidx[qi] * op.d + d0 + 8 * c;
      cp_async16(s + kRowBytes + qi * 128 + ((c ^ (qi & 7)) << 4), ok ? p : op.q, ok);
    }
  }
  __device__ __forceinline__ void arrived() const {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  // acc (+)= the stage's dimensions, 16 per instruction; `left` = d - d0.
  __device__ __forceinline__ void mma(const char* stage, bool first, int left) {
    const uint32_t s = smem_u32(stage);
    const uint64_t a = wgmma_desc(s + (threadIdx.x >> 7) * (64 * 128));
    const uint64_t b = wgmma_desc(s + kRowBytes);
    const int steps = left >= kDims ? kDims / 16 : (left + 15) / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if (steps == kDims / 16) {  // a whole stage: unrolled, so the wgmma need no waits between
#pragma unroll
      for (int ks = 0; ks < kDims / 16; ++ks)  // 32 bytes along K: 2 in the address field
        wgmma_m64n16k16(acc, a + 2 * ks, b + 2 * ks, !(first && ks == 0));
    } else {
      for (int ks = 0; ks < steps; ++ks)
        wgmma_m64n16k16(acc, a + 2 * ks, b + 2 * ks, !(first && ks == 0));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  }
};

template <typename T>
struct ItemFmaTile {
  using Storage = T;
  static constexpr int kQueries = kItemQueries;
  static constexpr int kDims = 16;          // dimensions per stage
  static constexpr int kXS = kTR + 4;       // floats per staged dimension of the rows
  static constexpr int kQS = kQueries;      // ... and of the queries
  static constexpr int kStageBytes = kDims * (kXS + kQS) * 4;
  static constexpr int kElems = 8;

  float acc[4][2];
  int tx, ty;  // rows 4 tx .. 4 tx + 3, queries 2 ty and 2 ty + 1

  __device__ __forceinline__ ItemFmaTile() : tx(threadIdx.x & 31), ty(threadIdx.x >> 5) {}
  __device__ __forceinline__ int row(int e) const { return 4 * tx + (e >> 1); }
  __device__ __forceinline__ int query(int e) const { return 2 * ty + (e & 1); }
  __device__ __forceinline__ float value(int e) const { return acc[e >> 1][e & 1]; }

  __device__ __forceinline__ void load(char* stage, const ItemOperands<T>& op, int, int r0,
                                       int row_end, int d0) const {
    float* s = reinterpret_cast<float*>(stage);
    stage_transposed<T, kTR, kXS>(s, op.emb, r0, row_end, d0, op.d);
    const int qi = threadIdx.x & (kQueries - 1), dim = threadIdx.x / kQueries;
    const bool ok = qi < op.nq && d0 + dim < op.d;
    const T* p = op.q + (size_t)op.qidx[qi] * op.d + d0 + dim;
    float* o = s + kDims * kXS + dim * kQS + qi;
    if constexpr (sizeof(T) == 4)
      cp_async4(smem_u32(o), ok ? p : op.q, ok);
    else
      *o = ok ? to_f32(*p) : 0.f;
  }
  __device__ __forceinline__ void arrived() const {}

  // acc += the stage's 16 dimensions, ascending; `first` starts from zero.
  __device__ __forceinline__ void mma(const char* stage, bool first, int) {
    if (first) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
    }
    const float* xs = reinterpret_cast<const float*>(stage) + 4 * tx;
    const float* qs = reinterpret_cast<const float*>(stage) + kDims * kXS + 2 * ty;
#pragma unroll
    for (int kk = 0; kk < kDims; ++kk) {
      const float4 x = *reinterpret_cast<const float4*>(xs + kk * kXS);
      const float2 q = *reinterpret_cast<const float2*>(qs + kk * kQS);
      const float xr[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = __fmaf_rn(xr[i], q.x, acc[i][0]);
        acc[i][1] = __fmaf_rn(xr[i], q.y, acc[i][1]);
      }
    }
  }
};

template <class Tile>
struct ItemLists {
  static constexpr int NQ = Tile::kQueries;
  static constexpr int kDumpRow = kTR + 4;  // floats per query slot of a chunk's dump
  using Gate = TopkLists<MmaTile, true>;    // for its order-preserving gate keys
  const float* emb_sq;
  float* ld;    // shared, [NQ][k], ascending under (distance, id)
  int* li;      // shared, [NQ][k]
  float* dump;  // shared, [2][NQ][kDumpRow]
  float* sqs;   // shared, [2][kTR]
  int* qidx;    // shared, [NQ]: the item's queries' batch rows
  int* slot;    // shared, [NQ]: their partial lists
  int* gate;    // device memory, [B]
  int k, nq, row_end;

  // Lay everything out at `mem` (the end of the ring).
  __device__ __forceinline__ void layout(char* mem, const float* norms, int k_) {
    emb_sq = norms;
    k = k_;
    ld = reinterpret_cast<float*>(mem);
    li = reinterpret_cast<int*>(ld + NQ * k);
    dump = reinterpret_cast<float*>(li + NQ * k);
    sqs = dump + 2 * NQ * kDumpRow;
    qidx = reinterpret_cast<int*>(sqs + 2 * kTR);
    slot = qidx + NQ;
  }

  // Empty every list. A barrier precedes their first use.
  __device__ __forceinline__ void clear() {
    for (int e = threadIdx.x; e < NQ * k; e += kThreads) {
      ld[e] = kPosInf;
      li[e] = -1;
    }
  }

  __device__ __forceinline__ void begin(int r0, int s) {
    if (threadIdx.x < kTR) {
      const int row = r0 + threadIdx.x;
      sqs[s * kTR + threadIdx.x] = row < row_end ? emb_sq[row] : kPosInf;
    }
  }

  // Rows past the item's end carry +3e38 (their norm), which never enters.
  __device__ __forceinline__ void chunk(const Tile& t, int r0, int s) {
    const float* sq = sqs + s * kTR;
    float* dp = dump + s * NQ * kDumpRow;
#pragma unroll
    for (int e = 0; e < Tile::kElems; ++e) {
      const int qq = t.query(e);
      if (qq < nq) {
        const int r = t.row(e);
        dp[qq * kDumpRow + r] = __fmaf_rn(-2.f, t.value(e), sq[r]);
      }
    }
    __syncthreads();  // the dump is whole; the other one was drained a chunk ago
    const int lane = threadIdx.x & 31;
    for (int qq = threadIdx.x >> 5; qq < nq; qq += kWarps) {
      float* qd = ld + qq * k;
      int* qi = li + qq * k;
      int* g_at = gate + qidx[qq];
      const float g = Gate::gate_value(*(volatile int*)g_at);
#pragma unroll
      for (int c0 = 0; c0 < kTR; c0 += 32) {
        const float v = dp[qq * kDumpRow + c0 + lane];
        warp_offer(qd, qi, k, v, r0 + c0 + lane, v <= g, lane);
      }
      if (lane == 0 && qi[k - 1] >= 0 && qd[k - 1] < g)  // a full list lowers the gate
        atomicMin(g_at, Gate::gate_key(qd[k - 1]));
    }
  }

  // Write each query's list to its partial slot of out [S, B, k]; the last
  // segment of a cluster also empties the slots of the segments it has not
  // (slot + 1 .. slot + spare), so every slot of the partials is written.
  __device__ __forceinline__ void write(float* out_d, int* out_i, int B, int spare) const {
    for (int e = threadIdx.x; e < nq * k * (1 + spare); e += kThreads) {
      const int j = e % k, rest = e / k, qq = rest % nq, extra = rest / nq;
      const size_t at = ((size_t)(slot[qq] + extra) * B + qidx[qq]) * k + j;
      out_d[at] = extra ? kPosInf : ld[qq * k + j];
      out_i[at] = extra ? -1 : li[qq * k + j];
    }
  }
};

// Dynamic shared memory of an item-scan launch: the alignment slack, the
// ring, the lists, the two dumps, the norms of two chunks and the item's
// query rows and slots.
template <class Tile>
constexpr int item_scan_smem(int k) {
  return 1024 + kItemStages * Tile::kStageBytes +
         Tile::kQueries * (8 * k + 2 * ItemLists<Tile>::kDumpRow * 4 + 8) + 2 * kTR * 4;
}

}  // namespace pqv
