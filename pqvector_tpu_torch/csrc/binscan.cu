// K7 and K8: the fused binned-min scan, over every tile (K7) or over a list
// of selected tiles (K8), in an f32/bf16 body and an int8 body.
//
// Replace pqvector_tpu/kernels/binscan.py: pallas_binned_scan
// (_binscan_kernel, _binscan8_kernel) and pallas_binned_scan_select
// (_binscan_select_kernel, _binscan8_select_kernel), all on _binscan_body.
//
// Each (query, row) pair gives one int32 key: the true squared distance
// (|q|^2 - 2 q.x + |x|^2) as f32 bits with the low code_bits replaced by
// the row's provenance (g3 << tg_bits) + tg. The key is min-folded into the
// query's bin (slab, lane) of a table [expand * n_lg, B, 128], with
// slab = (t + g3) % n_lg + (tg % expand) * n_lg, so the 128-row lane groups
// of one tile land in distinct slabs. t is the tile (K7) or the slot of the
// selected tile (K8), tg = t / n_lg, g3 the lane group within the tile.
//
// The TPU carries the table through an ordered grid and initialises a bin
// at its first touch. A CUDA grid has no order, so the table starts at
// INT32_MAX and blocks fold into it with atomicMin. The minimum does not
// depend on the order, and since every bin is touched (the wrapper checks
// nt >= expand * n_lg, or cap for K8) it equals the TPU's table.
//
// Block (query group of 16, slab, split) owns one slab of the table: for
// each slot of its slab block (tile groups with tg % expand == e) it scores
// the one lane group that folds into that slab, g3 = (slab - t) mod n_lg,
// so every (slot, lane group) pair is scored by exactly one block. Its share
// of the table is [16, 128], and thread (r, g), which scores lane r for
// queries 8g .. 8g+7, keeps its eight bins in registers: a plain min, no
// shared table and no atomics until the block folds them into the global
// table. Shared memory holds only the staged rows, so several blocks fit on
// an SM.
//
// What bounds it on the H100: the CUDA-core score loop (fp32 FMA from
// shared memory, 8 FMAs per 3 shared loads) and the staging of the rows,
// each of whose elements feeds 16 FMAs; rows are staged with 16-byte loads
// where their width allows. bf16 storage widens to fp32 on load, so its
// products are exact. The int8 body scores 4 codes per __dp4a with exact
// int32 sums, as the int8 MXU does. No tensor cores, TMA or wgmma yet.
//
// Arithmetic order fixes the key bits, so it follows the TPU's:
// f32/bf16 part = (scores + |x|^2) + |q|^2 with q pre-scaled by -2 in the
// storage dtype; int8 part = max((f32(dot) * (qt * sr) + |x|^2) + |q|^2, 0)
// with qt = -2 * (query scale). __fmul_rn/__fadd_rn keep nvcc from
// contracting these into FMAs.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace pqv {

constexpr int kBinQB = 16;      // queries per block
constexpr int kBinLanes = 128;  // rows of a lane group, lanes of a slab
constexpr int kBinQT = kBinQB * kBinLanes / kThreads;  // queries per thread
constexpr int kBinDK = 64;      // f32/bf16 dimensions staged per step
constexpr int kBinDW = 32;      // int8: 4-code words staged per step
static_assert(kBinQT == 8, "thread (r, g) scores row r for 8 queries");

struct BinArgs {
  const void* q;        // [B, d]: -2q in the storage dtype, or int8 codes
  const float* qsq;     // [B] |q|^2
  const float* qt;      // [B] -2 * query scale (int8 body)
  const void* emb;      // [n_pad, d] f32, bf16 or int8 codes
  const float* emb_sq;  // [n_pad] |x|^2, +3e38 on pad rows
  const float* scale;   // [n_pad] row scale (int8 body)
  const int* sel;       // [n_units] tile of each slot (K8), or null (K7)
  int* out;             // [expand * n_lg, B, 128], INT32_MAX on entry
  int B, d, tile, n_units, expand, tg_bits, code_bits, splits;
};

struct __align__(16) BinStage {
  union {
    struct {
      float x[kBinLanes][kBinDK + 1];  // +1 column: rows in distinct banks
      float qT[kBinDK][kBinQB];
    } f;
    struct {
      int x[kBinLanes][kBinDW + 1];
      int qT[kBinDW][kBinQB];
    } i;
  };
};

// The 16 bytes of w as f32 values: 4 floats, or 8 bf16 widened (a bf16 is
// the high half of an f32, so the widening is exact).
template <typename T>
__device__ __forceinline__ void widen16(const uint4& w, float* dst) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (std::is_same_v<T, float>) {
      dst[j] = __uint_as_float(u[j]);
    } else {
      dst[2 * j] = __uint_as_float(u[j] << 16);
      dst[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

// Stage rows row0 .. row0 + 127, dimensions d0 .. d0 + kBinDK - 1, as f32
// (zero past d): 16-byte loads where every row starts 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* emb, int d, size_t row0,
                                           int d0, float (*x)[kBinDK + 1]) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kBinDK / kVec;
  if (d % kVec == 0 && (reinterpret_cast<uintptr_t>(emb) & 15) == 0) {
    for (int v = threadIdx.x; v < kBinLanes * kPerRow; v += kThreads) {
      const int rr = v / kPerRow, cc = (v % kPerRow) * kVec;
      float* dst = &x[rr][cc];
      if (d0 + cc < d) {
        widen16<T>(*reinterpret_cast<const uint4*>(emb + (row0 + rr) * d + d0 + cc), dst);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) dst[j] = 0.f;
      }
    }
  } else {
    for (int e = threadIdx.x; e < kBinLanes * kBinDK; e += kThreads) {
      const int rr = e / kBinDK, cc = e % kBinDK, col = d0 + cc;
      x[rr][cc] = col < d ? to_f32(emb[(row0 + rr) * d + col]) : 0.f;
    }
  }
}

// Dot products of one lane group (rows row0 .. row0 + 127) with the block's
// queries: thread (r, g) gets row row0 + r for queries 8g .. 8g + 7.
template <typename T>
__device__ __forceinline__ void score_lane_group(const BinArgs& a, BinStage& s,
                                                 int q0, size_t row0,
                                                 float acc[kBinQT]) {
  const T* q = static_cast<const T*>(a.q);
  const int t = threadIdx.x, r = t % kBinLanes, g = t / kBinLanes;
  for (int d0 = 0; d0 < a.d; d0 += kBinDK) {
    stage_rows<T>(static_cast<const T*>(a.emb), a.d, row0, d0, s.f.x);
    for (int e = t; e < kBinQB * kBinDK; e += kThreads) {
      const int qq = e / kBinDK, cc = e % kBinDK;
      const int b = q0 + qq, col = d0 + cc;
      s.f.qT[cc][qq] =
          (b < a.B && col < a.d) ? to_f32(q[(size_t)b * a.d + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < kBinDK; ++cc) {
      const float xv = s.f.x[r][cc];
      const float4 qa = *reinterpret_cast<const float4*>(&s.f.qT[cc][kBinQT * g]);
      const float4 qb = *reinterpret_cast<const float4*>(&s.f.qT[cc][kBinQT * g + 4]);
      acc[0] = fmaf(xv, qa.x, acc[0]);
      acc[1] = fmaf(xv, qa.y, acc[1]);
      acc[2] = fmaf(xv, qa.z, acc[2]);
      acc[3] = fmaf(xv, qa.w, acc[3]);
      acc[4] = fmaf(xv, qb.x, acc[4]);
      acc[5] = fmaf(xv, qb.y, acc[5]);
      acc[6] = fmaf(xv, qb.z, acc[6]);
      acc[7] = fmaf(xv, qb.w, acc[7]);
    }
    __syncthreads();
  }
}

// Four int8 codes p[col .. col + 3] as one word, zero past d.
__device__ __forceinline__ int load_word(const int8_t* p, int col, int d) {
  if (col + 3 < d && (reinterpret_cast<uintptr_t>(p + col) & 3) == 0)
    return *reinterpret_cast<const int*>(p + col);
  unsigned w = 0;
  for (int j = 0; j < 4; ++j)
    if (col + j < d) w |= (unsigned)(uint8_t)p[col + j] << (8 * j);
  return (int)w;
}

__device__ __forceinline__ void score_lane_group_i8(const BinArgs& a,
                                                    BinStage& s, int q0,
                                                    size_t row0,
                                                    int acc[kBinQT]) {
  const int8_t* q = static_cast<const int8_t*>(a.q);
  const int8_t* emb = static_cast<const int8_t*>(a.emb);
  const int t = threadIdx.x, r = t % kBinLanes, g = t / kBinLanes;
  // 16 codes per load where every row starts 16-byte aligned
  const bool vec = a.d % 16 == 0 && (reinterpret_cast<uintptr_t>(emb) & 15) == 0;
  for (int d0 = 0; d0 < a.d; d0 += 4 * kBinDW) {
    if (vec) {
      for (int v = t; v < kBinLanes * kBinDW / 4; v += kThreads) {
        const int rr = v / (kBinDW / 4), w = (v % (kBinDW / 4)) * 4;
        const int col = d0 + 4 * w;
        const int4 c = col < a.d
            ? *reinterpret_cast<const int4*>(emb + (row0 + rr) * a.d + col)
            : make_int4(0, 0, 0, 0);
        s.i.x[rr][w] = c.x;
        s.i.x[rr][w + 1] = c.y;
        s.i.x[rr][w + 2] = c.z;
        s.i.x[rr][w + 3] = c.w;
      }
    } else {
      for (int e = t; e < kBinLanes * kBinDW; e += kThreads) {
        const int rr = e / kBinDW, w = e % kBinDW, col = d0 + 4 * w;
        s.i.x[rr][w] = col < a.d ? load_word(emb + (row0 + rr) * a.d, col, a.d) : 0;
      }
    }
    for (int e = t; e < kBinQB * kBinDW; e += kThreads) {
      const int qq = e / kBinDW, w = e % kBinDW;
      const int b = q0 + qq, col = d0 + 4 * w;
      s.i.qT[w][qq] = (b < a.B && col < a.d)
                          ? load_word(q + (size_t)b * a.d, col, a.d)
                          : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int w = 0; w < kBinDW; ++w) {
      const int xv = s.i.x[r][w];
      const int4 qa = *reinterpret_cast<const int4*>(&s.i.qT[w][kBinQT * g]);
      const int4 qb = *reinterpret_cast<const int4*>(&s.i.qT[w][kBinQT * g + 4]);
      acc[0] = __dp4a(xv, qa.x, acc[0]);
      acc[1] = __dp4a(xv, qa.y, acc[1]);
      acc[2] = __dp4a(xv, qa.z, acc[2]);
      acc[3] = __dp4a(xv, qa.w, acc[3]);
      acc[4] = __dp4a(xv, qb.x, acc[4]);
      acc[5] = __dp4a(xv, qb.y, acc[5]);
      acc[6] = __dp4a(xv, qb.z, acc[6]);
      acc[7] = __dp4a(xv, qb.w, acc[7]);
    }
    __syncthreads();
  }
}

// DT: 0 f32, 1 bf16, 2 int8 codes.
template <int DT>
__global__ void __launch_bounds__(kThreads) binscan_kernel(BinArgs a) {
  __shared__ BinStage s;
  const int q0 = blockIdx.x * kBinQB;
  const int n_lg = a.tile / kBinLanes;
  const int e = blockIdx.y / n_lg;   // slab block
  const int sl = blockIdx.y % n_lg;  // slab within it
  // Slots of slab block e, in order: tile groups e, e + expand, ...; only
  // the last tile group may be partial.
  const int full = a.n_units / n_lg, rem = a.n_units % n_lg;
  const long long m_full = full > e ? (full - e + a.expand - 1) / a.expand : 0;
  const long long cnt =
      m_full * n_lg + ((rem && full % a.expand == e) ? rem : 0);
  const int lo = (int)(cnt * blockIdx.z / a.splits);
  const int hi = (int)(cnt * (blockIdx.z + 1) / a.splits);
  if (lo >= hi) return;  // uniform across the block
  const int t = threadIdx.x, r = t % kBinLanes, g = t / kBinLanes;
  const int hi_mask = ~((1 << a.code_bits) - 1);
  float qsq[kBinQT], qt[kBinQT];
  int best[kBinQT];
#pragma unroll
  for (int j = 0; j < kBinQT; ++j) {
    const int b = q0 + kBinQT * g + j;
    qsq[j] = b < a.B ? a.qsq[b] : 0.f;
    qt[j] = (DT == 2 && b < a.B) ? a.qt[b] : 0.f;
    best[j] = INT_MAX;
  }
  for (int i = lo; i < hi; ++i) {
    const int slot = (e + (i / n_lg) * a.expand) * n_lg + i % n_lg;
    const int tile_id = a.sel ? a.sel[slot] : slot;
    const int tg = slot / n_lg;
    const int g3 = (sl - slot % n_lg + n_lg) % n_lg;  // (slot + g3) % n_lg == sl
    const size_t row0 = (size_t)tile_id * a.tile + (size_t)g3 * kBinLanes;
    const size_t row = row0 + r;
    float part[kBinQT];
    if constexpr (DT == 2) {
      int acc[kBinQT] = {};
      score_lane_group_i8(a, s, q0, row0, acc);
      const float sr = a.scale[row], sq = a.emb_sq[row];
#pragma unroll
      for (int j = 0; j < kBinQT; ++j) {
        const float sc = __fmul_rn(__int2float_rn(acc[j]), __fmul_rn(qt[j], sr));
        const float p = __fadd_rn(__fadd_rn(sc, sq), qsq[j]);
        part[j] = p < 0.f ? 0.f : p;  // quantization can push 0 below
      }
    } else {
      float acc[kBinQT] = {};
      using T = std::conditional_t<DT == 1, __nv_bfloat16, float>;
      score_lane_group<T>(a, s, q0, row0, acc);
      const float sq = a.emb_sq[row];
#pragma unroll
      for (int j = 0; j < kBinQT; ++j) part[j] = __fadd_rn(__fadd_rn(acc[j], sq), qsq[j]);
    }
    const int code = (g3 << a.tg_bits) + tg;
#pragma unroll
    for (int j = 0; j < kBinQT; ++j)
      best[j] = min(best[j], (__float_as_int(part[j]) & hi_mask) | code);
  }
#pragma unroll
  for (int j = 0; j < kBinQT; ++j) {
    const int b = q0 + kBinQT * g + j;
    if (b < a.B) atomicMin(&a.out[((size_t)blockIdx.y * a.B + b) * kBinLanes + r], best[j]);
  }
}

int launch_binscan(const BinArgs& a, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(ceil_div(a.B, kBinQB), a.expand * (a.tile / kBinLanes), a.splits);
  switch (dtype) {
    case 0:
      binscan_kernel<0><<<grid, kThreads, 0, st>>>(a);
      break;
    case 1:
      binscan_kernel<1><<<grid, kThreads, 0, st>>>(a);
      break;
    case 2:
      binscan_kernel<2><<<grid, kThreads, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

BinArgs bin_args(const void* q, const float* qsq, const float* qt,
                 const void* emb, const float* emb_sq, const float* scale,
                 const int* sel, int B, int d, int tile, int n_units,
                 int expand, int tg_bits, int code_bits, int splits, int* out) {
  BinArgs a = {};
  a.q = q;
  a.qsq = qsq;
  a.qt = qt;
  a.emb = emb;
  a.emb_sq = emb_sq;
  a.scale = scale;
  a.sel = sel;
  a.out = out;
  a.B = B;
  a.d = d;
  a.tile = tile;
  a.n_units = n_units;
  a.expand = expand;
  a.tg_bits = tg_bits;
  a.code_bits = code_bits;
  a.splits = splits;
  return a;
}

}  // namespace pqv

// K7: every tile; n_units = nt. dtype 0 f32, 1 bf16, 2 int8 (qt and scale
// are read only then). out [expand * tile/128, B, 128] holds INT32_MAX.
extern "C" int pqv_binned_scan(const void* q, const float* qsq, const float* qt,
                               const void* emb, const float* emb_sq,
                               const float* scale, int B, int d, int tile,
                               int n_units, int expand, int tg_bits,
                               int code_bits, int splits, int dtype, int* out,
                               void* stream) {
  return pqv::launch_binscan(
      pqv::bin_args(q, qsq, qt, emb, emb_sq, scale, nullptr, B, d, tile,
                    n_units, expand, tg_bits, code_bits, splits, out),
      dtype, stream);
}

// K8: slot t scans tile sel[t]; n_units = cap, the length of sel.
extern "C" int pqv_binned_scan_select(const void* q, const float* qsq,
                                      const float* qt, const void* emb,
                                      const float* emb_sq, const float* scale,
                                      const int* sel, int B, int d, int tile,
                                      int n_units, int expand, int tg_bits,
                                      int code_bits, int splits, int dtype,
                                      int* out, void* stream) {
  return pqv::launch_binscan(
      pqv::bin_args(q, qsq, qt, emb, emb_sq, scale, sel, B, d, tile, n_units,
                    expand, tg_bits, code_bits, splits, out),
      dtype, stream);
}
