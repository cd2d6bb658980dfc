// The cross-tile merge: per-tile top-k lists [nt, B, kk] -> each query's k
// smallest (distance, id) pairs [B, k], ascending.
//
// Replaces no TPU kernel: pqvector_tpu/kernels/scan_topk.py:_final_merge is
// XLA code outside the Pallas calls (a top-k over the [B, nt * kk] block),
// and the port ran it as torch's two stable argsorts over that block
// (select_lex), ~3.5 ms a call at nt = 978, B = 256, k = 100 on the H100.
// Those sorts order every slot, but a query that probes a few clusters finds
// candidates in a few percent of its lists; every other slot is the empty
// slot (+3e38, -1).
//
// One block a query. Its threads test the nt list heads, 256 at a time, and
// compact the lists whose head is a candidate (below 3e38) and not beyond
// the running k-th key into a queue (ballot, prefix sum over the warps).
// Each warp then takes a list and appends, 32 slots at a time, the entries
// at or below the running k-th key to a buffer in shared memory; it stops
// reading the list at the first entry past the k-th key's distance or at its
// first empty slot. When the buffer could overflow, and at the end, the
// block sorts it (bitonic, in shared memory) and keeps its first k, whose
// last is the new running k-th key. What bounds it: the heads, one 32-byte
// sector each (nt x B of them), and the barriers of the sorts; the bytes of
// the lists it reads are few.
//
// The order is torch's stable sorts': a 64-bit key (distance as ordered
// bits with -0.0 taken as +0.0, then id), then the slot's place in the
// [B, nt * kk] block. Entries are written with the bits they came with. The
// lists must be ascending in distance, as K4, K5 and K6 write them (the ids
// of equal distances in any order). A slot at or above 3e38, or a NaN, is
// an empty slot: the scan kernels write nothing else there, since a row
// enters a list only by beating (+3e38, -1). Slots a query cannot fill get
// (+3e38, -1).
#include "common.cuh"

namespace pqv {

constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kMergeCap = 2048;  // entries the buffer holds
static_assert(kMergeCap >= kMaxK + kMergeWarps * kMaxK,
              "a round of full lists must fit beside k kept entries");

// Distance bits in an unsigned order that is the float order, -0.0 = +0.0.
__device__ __forceinline__ unsigned dist_bits(float d) {
  unsigned u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long merge_key(unsigned dk, int id) {
  return ((unsigned long long)dk << 32) | (unsigned)(id ^ 0x80000000);
}

struct MergeBuffer {
  unsigned long long key[kMergeCap];
  unsigned pos[kMergeCap];  // t * kk + slot: the place in the [B, nt * kk] block
  int queue[kMergeThreads];
  int warp_n[kMergeWarps];
  int count, lists;
  unsigned long long theta;  // the running k-th key; all ones until k are held
};

// Sort the buffer's entries by (key, pos) and keep the first k. Every
// thread calls it with the same count; it ends with a barrier.
__device__ __forceinline__ void compact(MergeBuffer& m, int k) {
  const int n = m.count;
  int p = 32;
  while (p < n) p <<= 1;
  for (int e = n + threadIdx.x; e < p; e += kMergeThreads) {
    m.key[e] = ~0ull;
    m.pos[e] = ~0u;
  }
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += kMergeThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = m.key[lo], c = m.key[hi];
        const unsigned pa = m.pos[lo], pc = m.pos[hi];
        const bool greater = a > c || (a == c && pa > pc);
        if (greater == ((lo & size) == 0)) {
          m.key[lo] = c;
          m.key[hi] = a;
          m.pos[lo] = pc;
          m.pos[hi] = pa;
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) {
    m.count = min(n, k);
    if (n >= k) m.theta = m.key[k - 1];
  }
  __syncthreads();
}

// Warp: append list t's entries at or below the running k-th key.
__device__ __forceinline__ void take_list(MergeBuffer& m, const float* __restrict__ td,
                                          const int* __restrict__ ti, int t, int b, int B,
                                          int kk, int lane) {
  const size_t base = ((size_t)t * B + b) * kk;
  const unsigned long long th = m.theta;
  const unsigned th_d = (unsigned)(th >> 32);
  for (int s0 = 0; s0 < kk; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < kk;
    const float d = in ? td[base + s] : kPosInf;
    const bool cand = d < kPosInf;  // false for an empty slot and for NaN
    const unsigned dk = dist_bits(d);
    const int id = cand ? ti[base + s] : -1;
    const unsigned long long key = merge_key(dk, id);
    const bool keep = cand && key <= th;
    const unsigned won = __ballot_sync(kFull, keep);
    if (won) {
      int at = 0;
      if (lane == 0) at = atomicAdd(&m.count, __popc(won));
      at = __shfl_sync(kFull, at, 0) + __popc(won & ((1u << lane) - 1u));
      if (keep) {
        m.key[at] = key;
        m.pos[at] = (unsigned)(t * kk + s);
      }
    }
    // The list is ascending: past this entry nothing can win.
    if (__any_sync(kFull, in && (!cand || dk > th_d))) break;
  }
}

__global__ void __launch_bounds__(kMergeThreads)
    merge_lists_kernel(const float* __restrict__ td, const int* __restrict__ ti, int nt, int B,
                       int kk, int k, int kout, int* stats, float* __restrict__ out_d,
                       int* __restrict__ out_i) {
  __shared__ MergeBuffer m;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    m.count = m.lists = 0;
    m.theta = ~0ull;
  }
  int found = 0;
  __syncthreads();
  for (int t0 = 0; t0 < nt; t0 += kMergeThreads) {
    const int t = t0 + threadIdx.x;
    bool live = false;
    if (t < nt) {
      const float h = td[((size_t)t * B + b) * kk];
      if (h < kPosInf) {
        ++found;
        live = dist_bits(h) <= (unsigned)(m.theta >> 32);
      }
    }
    const unsigned lv = __ballot_sync(kFull, live);
    if (lane == 0) m.warp_n[warp] = __popc(lv);
    __syncthreads();
    int at = 0, nlive = 0;
#pragma unroll
    for (int w = 0; w < kMergeWarps; ++w) {
      const int c = m.warp_n[w];
      at += w < warp ? c : 0;
      nlive += c;
    }
    if (live) m.queue[at + __popc(lv & ((1u << lane) - 1u))] = t;
    __syncthreads();
    for (int j0 = 0; j0 < nlive; j0 += kMergeWarps) {
      if (m.count > kMergeCap - kMergeWarps * kk) compact(m, k);
      if (j0 + warp < nlive) take_list(m, td, ti, m.queue[j0 + warp], b, B, kk, lane);
      __syncthreads();
    }
  }
  compact(m, k);
  const int n = m.count;
  for (int j = threadIdx.x; j < kout; j += kMergeThreads) {
    float d = kPosInf;
    int id = -1;
    if (j < n) {
      const unsigned p = m.pos[j];
      const int t = (int)(p / (unsigned)kk), s = (int)(p % (unsigned)kk);
      d = td[((size_t)t * B + b) * kk + s];
      id = (int)((unsigned)m.key[j] ^ 0x80000000u);
    }
    out_d[(size_t)b * kout + j] = d;
    out_i[(size_t)b * kout + j] = id;
  }
  if (stats != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) found += __shfl_xor_sync(kFull, found, off);
    if (lane == 0 && found) atomicAdd(&m.lists, found);
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(stats, m.lists);
      atomicAdd(stats + 1, nt);
    }
  }
}

}  // namespace pqv

// td [nt, B, kk] f32 and ti [nt, B, kk] int32, each list ascending in
// distance; out [B, kout] with kout = min(k, nt * kk); stats is null or two
// int32 counters the launch adds the lists it found non-empty and the heads
// it tested to.
extern "C" int pqv_merge_lists(const float* td, const int* ti, int nt, int B, int kk, int k,
                               int* stats, float* out_d, int* out_i, void* stream) {
  using namespace pqv;
  if (nt < 1 || B < 1 || kk < 1 || kk > kMaxK || k < 1 || k > kMaxK ||
      (long long)nt * kk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int kout = (long long)nt * kk < k ? nt * kk : k;
  merge_lists_kernel<<<B, kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      td, ti, nt, B, kk, k, kout, stats, out_d, out_i);
  return (int)cudaGetLastError();
}
