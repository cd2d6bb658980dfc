// The score tile of K9 (tile min), K5 (exact per-tile top-k), K4 and K6
// (masked per-tile top-k), K2 (streaming exact top-k), K1 (nearest-centroid
// assign) and K7 and K8 (the binned-min scan) for sm_90a; K3's item tiles
// (item_scan.cuh) walk its ring.
//
// A block of 256 threads owns up to 128 queries and walks a range of rows in
// chunks of 128. The 128 x 128 dot products q.x of one chunk live in
// registers and never reach device memory; an epilogue (a fold to per-tile
// minima, per-query top-k lists, a running argmin with K1's data rows as
// the queries and its centroids as the rows, or K7's per-lane minimum of
// packed keys) consumes them chunk by chunk. K4 and K6 walk only the
// chunks that hold a row some query of the block probes (walk_chunks,
// MaskChunks); K7 and K8 walk 128-row chunks that are not neighbours, one
// lane group of each tile (walk_list). Slices of both operands arrive in a
// ring of shared-memory stages filled by cp.async, so the copies of the next
// slices overlap the arithmetic of this one and one __syncthreads() per
// slice is all the walk needs.
//
// Three back ends compute the sums, chosen by the caller from the shapes alone:
//
// FmaTile, IEEE fp32 on the CUDA cores. A thread keeps an 8 rows x 8 queries
//   patch (8 x 4 for a batch of at most 64). A stage holds 16 dimensions of
//   the 128 rows and of the queries, transposed ([dimension][row]), so a
//   thread reads its 8 rows and its 8 queries of one dimension with two
//   16-byte loads each: 4 loads feed 64 FMAs. The transposition costs
//   nothing: f32 storage is copied by 4-byte cp.async, each element straight
//   to its transposed place (a row stride of 132 floats keeps those writes
//   and the 16-byte reads free of bank conflicts), which also takes any row
//   alignment (d = 3). bf16 storage that the tensor cores cannot take is
//   widened in registers on the way in. K1's bf16 data rows (Bf16RowFmaTile)
//   are copied raw by 16-byte cp.async and widened into place once they land.
//   Every sum adds its products in ascending dimension order with
//   __fmaf_rn, from a zero start.
//
// Dp4aTile, int8 codes on the CUDA cores (K7 and K8). FmaTile's patch and
//   stages, with 4-code words in place of floats: a stage holds 16 words (64
//   dimensions), and each __dp4a adds 4 exact products to an int32 sum.
//   Words are copied by 4-byte cp.async where d % 4 == 0 and assembled from
//   bytes otherwise, zero past d, so any d is taken.
//
// MmaTile, bf16 x bf16 with fp32 accumulation on the tensor cores. Each of
//   the two warpgroups runs wgmma.mma_async m64n128k16 with its 64 queries
//   as M and the chunk's 128 rows as N, both operands K-major in shared
//   memory under the 128-byte swizzle: a stage holds 64 dimensions (128
//   bytes) of 128 queries and 128 rows, written by 16-byte cp.async with the
//   XOR applied to the destination. Dimensions past d and rows past the end
//   are zero-filled by the copy (src-size 0), so d = 96 or 8 need no second
//   code path. It needs 16-byte aligned rows: d % 8 == 0. The products are
//   exact; only the order of the fp32 additions is the hardware's. K1's
//   screen (ScreenTile) stages each query slice once beside three bf16
//   pieces of the f32 centroids and sums a stage's products apart; its
//   screen over f32 rows (ScreenTileF32) copies the query slice raw, splits
//   it into two bf16 pieces in place and walks with walk_rows_lagged.
//
// With queries as M a thread of the warpgroup holds two queries and, of the
// chunk's rows, 16 groups of 2 consecutive ones, a group's neighbours in the
// 3 other lanes of its quad: a tile's rows sit in one thread and 4 lanes.
// The patch of FmaTile and Dp4aTile (PatchLayout) holds 2 groups of 4
// consecutive rows, neighbours in 16 lanes. All back ends describe their
// registers by the same few constants (kGroups, kRun, kXor, kSpan) and
// accessors, and the epilogues are written against those.
#pragma once

#include "common.cuh"

namespace pqv {

constexpr int kTR = 128;  // rows of a chunk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies of 4 or 16 bytes; with ok false nothing is read and
// the destination is zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What a walk scores: queries [B, d] against rows [.., d], one storage type.
template <typename T>
struct TileOperands {
  const T* q;
  const T* emb;
  int B, d;
};

// The same with queries of their own type Q and f32 rows: K1's bf16-row form,
// whose data rows are the queries and whose centroids are the rows.
template <typename Q>
struct WideningOperands {
  const Q* q;
  const float* emb;
  int B, d;
};

// K1's screen: bf16 queries [B, d] (K1's data rows) and the centroids split
// into three bf16 pieces, pieces [3][k][d] (hi, mid, lo: hi + mid + lo == c).
struct SplitOperands {
  const __nv_bfloat16* q;
  const __nv_bfloat16* pieces;
  int B, d, k;
};

// K1's screen over f32 rows: f32 queries [B, d] and the same centroid pieces.
struct SplitOperandsF32 {
  const float* q;
  const __nv_bfloat16* pieces;
  int B, d, k;
};

// ------------------------------------------------------------ fp32, FMA

// Stage `ROWS` rows x 16 dimensions of `src` transposed: dst[dim][row], row
// stride STRIDE floats. Warp w, lane l copies dimension (l >> 2) + 8 (w & 1)
// of rows (l & 3) + 4 (w >> 1) + 16 i: a warp reads 4 rows x 32 bytes and
// writes 32 distinct banks.
template <typename T, int ROWS, int STRIDE>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src, int row0,
                                                 int row_limit, int d0, int d) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int dim = (lane >> 2) + 8 * (w & 1);
  const int rb = (lane & 3) + 4 * (w >> 1);
  const bool dim_ok = d0 + dim < d;
  const T* p = src + (size_t)(row0 + rb) * d + d0 + dim;
  float* o = dst + dim * STRIDE + rb;
  if constexpr (sizeof(T) == 4) {
    const uint32_t o32 = smem_u32(o);
#pragma unroll
    for (int i = 0; i < ROWS / 16; ++i) {
      const bool ok = dim_ok && row0 + rb + 16 * i < row_limit;
      cp_async4(o32 + 64 * i, ok ? p + (size_t)16 * i * d : src, ok);
    }
  } else {
    float v[ROWS / 16];
#pragma unroll
    for (int i = 0; i < ROWS / 16; ++i) {
      const bool ok = dim_ok && row0 + rb + 16 * i < row_limit;
      v[i] = ok ? to_f32(p[(size_t)16 * i * d]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < ROWS / 16; ++i) o[16 * i] = v[i];
  }
}

// The register patch of FmaTile and Dp4aTile: NQ queries per thread, the
// block owns 16 NQ queries (NQ is 8 or 4). A stage holds 4-byte elements
// (floats, or words of 4 int8 codes) transposed, kXS per staged row element
// and kQS per staged query element.
template <int NQ>
struct PatchLayout {
  static constexpr int kQueries = 16 * NQ;
  static constexpr int kXS = kTR + 4;       // elements per staged dimension (word)
  static constexpr int kQS = kQueries + 4;
  // Register layout: kGroups groups of kRun consecutive rows per thread; the
  // rows between a group's runs are in the lanes at XOR distance 1, 2, ...,
  // 2^(kXor-1) (row_lane() numbers them), which together span kSpan rows.
  static constexpr int kPerThread = NQ;  // queries per thread
  static constexpr int kGroups = 2, kRun = 4, kXor = 4, kSpan = 64;

  int tx, ty;

  __device__ __forceinline__ PatchLayout() : tx(threadIdx.x & 15), ty(threadIdx.x >> 4) {}
  __device__ __forceinline__ int query(int jq) const {
    return jq < 4 ? 4 * ty + jq : 60 + 4 * ty + jq;
  }
  __device__ __forceinline__ int row_base(int g) const { return 64 * g + 4 * tx; }
  __device__ __forceinline__ int row_lane() const { return tx; }
  static __device__ __forceinline__ int half_of(int g) { return g; }
};

template <typename T, int NQ>
struct FmaTile : PatchLayout<NQ> {
  using Storage = T;
  using PatchLayout<NQ>::kQueries;
  using PatchLayout<NQ>::kXS;
  using PatchLayout<NQ>::kQS;
  using PatchLayout<NQ>::tx;
  using PatchLayout<NQ>::ty;
  static constexpr int kDims = 16;          // dimensions per stage
  static constexpr int kStageBytes = kDims * (kXS + kQS) * 4;

  float acc[8][NQ];

  __device__ __forceinline__ float value(int g, int l, int jq) const {
    return acc[4 * g + l][jq];
  }

  __device__ __forceinline__ void load(char* stage, const TileOperands<T>& op, int q0,
                                       int r0, int row_end, int d0) const {
    float* s = reinterpret_cast<float*>(stage);
    stage_transposed<T, kTR, kXS>(s, op.emb, r0, row_end, d0, op.d);
    stage_transposed<T, kQueries, kQS>(s + kDims * kXS, op.q, q0, op.B, d0, op.d);
  }
  __device__ __forceinline__ void arrived() const {}

  // acc += the stage's 16 dimensions, ascending; `first` starts from zero.
  __device__ __forceinline__ void mma(const char* stage, bool first, int) {
    if (first) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NQ; ++j) acc[i][j] = 0.f;
    }
    const float* xs = reinterpret_cast<const float*>(stage) + 4 * tx;
    const float* qs = reinterpret_cast<const float*>(stage) + kDims * kXS + 4 * ty;
#pragma unroll
    for (int kk = 0; kk < kDims; ++kk) {
      const float4 xa = *reinterpret_cast<const float4*>(xs + kk * kXS);
      const float4 xb = *reinterpret_cast<const float4*>(xs + kk * kXS + 64);
      const float4 qa = *reinterpret_cast<const float4*>(qs + kk * kQS);
      const float xr[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      float qr[NQ] = {qa.x, qa.y, qa.z, qa.w};
      if constexpr (NQ == 8) {
        const float4 qb = *reinterpret_cast<const float4*>(qs + kk * kQS + 64);
        qr[4] = qb.x, qr[5] = qb.y, qr[6] = qb.z, qr[7] = qb.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NQ; ++j) acc[i][j] = __fmaf_rn(xr[i], qr[j], acc[i][j]);
    }
  }
};

// FmaTile<float, 8> over WideningOperands<bf16>: K1's bf16-row form on the
// CUDA cores. The f32 rows (K1's centroids) are staged as FmaTile's; each
// thread copies 8 dimensions of one bf16 query (one of K1's data rows) raw
// into a third area of the stage with one 16-byte cp.async, and once its own
// copies have landed (arrived(), before the walk's barrier) widens them into
// FmaTile's transposed query area. FmaTile::mma then reads f32 as it does for
// K1 f32: the sums are its own on the widened values (exact), bit for bit.
// kVec: the rows are 16-byte aligned (d % 8 == 0 and an aligned base); else
// each element is read and widened on its own as the stage is filled.
// STAGES is the walk's: arrived() follows the ring's slots itself.
template <bool kVec, int STAGES>
struct Bf16RowFmaTile : FmaTile<float, 8> {
  using Base = FmaTile<float, 8>;
  using Storage = __nv_bfloat16;
  static constexpr int kStageBytes = Base::kStageBytes + kQueries * kDims * 2;

  char* ring;    // the walk's ring
  int next = 0;  // its slot whose queries arrived() widens next

  __device__ __forceinline__ void load(char* stage, const WideningOperands<Storage>& op,
                                       int q0, int r0, int row_end, int d0) const {
    float* s = reinterpret_cast<float*>(stage);
    stage_transposed<float, kTR, kXS>(s, op.emb, r0, row_end, d0, op.d);
    if constexpr (kVec) {
      const int qi = threadIdx.x >> 1, h = threadIdx.x & 1;
      const bool ok = q0 + qi < op.B && d0 + 8 * h < op.d;
      const Storage* p = op.q + (size_t)(q0 + qi) * op.d + d0 + 8 * h;
      cp_async16(smem_u32(stage + Base::kStageBytes + 16 * threadIdx.x), ok ? p : op.q, ok);
    } else {
      float* o = s + kDims * kXS;
#pragma unroll 1
      for (int e = threadIdx.x; e < kQueries * kDims; e += kThreads) {
        const int qi = e & (kQueries - 1), dim = e >> 7;
        const bool ok = q0 + qi < op.B && d0 + dim < op.d;
        o[dim * kQS + qi] = ok ? to_f32(op.q[(size_t)(q0 + qi) * op.d + d0 + dim]) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void arrived() {
    if constexpr (kVec) {
      char* stage = ring + next * kStageBytes;
      next = next + 1 == STAGES ? 0 : next + 1;
      const uint4 v = *reinterpret_cast<const uint4*>(stage + Base::kStageBytes +
                                                      16 * threadIdx.x);
      float* o = reinterpret_cast<float*>(stage) + kDims * kXS +
                 8 * (threadIdx.x & 1) * kQS + (threadIdx.x >> 1);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[2 * e * kQS] = __uint_as_float(w[e] << 16);
        o[(2 * e + 1) * kQS] = __uint_as_float(w[e] & 0xffff0000u);
      }
    }
  }
};

// ------------------------------------------------------------ int8, dp4a

// Stage `ROWS` rows x 16 four-code words of int8 `src` transposed, as
// stage_transposed stages floats: dst[word][row], the codes of dimensions
// d0 + 4 w .. d0 + 4 w + 3 in word w, zero past d. `by4`: every row starts
// 4-byte aligned (d % 4 == 0), so a word is one 4-byte cp.async; else it is
// assembled from single bytes.
template <int ROWS, int STRIDE>
__device__ __forceinline__ void stage_words(int* dst, const int8_t* src, int row0,
                                           int row_limit, int d0, int d, bool by4) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int word = (lane >> 2) + 8 * (w & 1);
  const int rb = (lane & 3) + 4 * (w >> 1);
  const int col = d0 + 4 * word;
  const int8_t* p = src + (size_t)(row0 + rb) * d + col;
  int* o = dst + word * STRIDE + rb;
  if (by4) {
    const uint32_t o32 = smem_u32(o);
#pragma unroll
    for (int i = 0; i < ROWS / 16; ++i) {
      const bool ok = col < d && row0 + rb + 16 * i < row_limit;
      cp_async4(o32 + 64 * i, ok ? p + (size_t)16 * i * d : src, ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < ROWS / 16; ++i) {
      uint32_t v = 0;
      if (row0 + rb + 16 * i < row_limit) {
        const int8_t* r = p + (size_t)16 * i * d;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < d) v |= (uint32_t)(uint8_t)r[j] << (8 * j);
      }
      o[16 * i] = (int)v;
    }
  }
}

template <int NQ>
struct Dp4aTile : PatchLayout<NQ> {
  using Storage = int8_t;
  using PatchLayout<NQ>::kQueries;
  using PatchLayout<NQ>::kXS;
  using PatchLayout<NQ>::kQS;
  using PatchLayout<NQ>::tx;
  using PatchLayout<NQ>::ty;
  static constexpr int kWords = 16;         // four-code words per stage
  static constexpr int kDims = 4 * kWords;  // dimensions per stage
  static constexpr int kStageBytes = kWords * (kXS + kQS) * 4;

  int acc[8][NQ];

  __device__ __forceinline__ int value(int g, int l, int jq) const {
    return acc[4 * g + l][jq];
  }

  __device__ __forceinline__ void load(char* stage, const TileOperands<int8_t>& op, int q0,
                                       int r0, int row_end, int d0) const {
    int* s = reinterpret_cast<int*>(stage);
    const bool by4 = op.d % 4 == 0 && ((uintptr_t)op.q | (uintptr_t)op.emb) % 4 == 0;
    stage_words<kTR, kXS>(s, op.emb, r0, row_end, d0, op.d, by4);
    stage_words<kQueries, kQS>(s + kWords * kXS, op.q, q0, op.B, d0, op.d, by4);
  }
  __device__ __forceinline__ void arrived() const {}

  // acc += the stage's 16 words, ascending; `first` starts from zero. The
  // int32 sums are exact.
  __device__ __forceinline__ void mma(const char* stage, bool first, int) {
    if (first) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NQ; ++j) acc[i][j] = 0;
    }
    const int* xs = reinterpret_cast<const int*>(stage) + 4 * tx;
    const int* qs = reinterpret_cast<const int*>(stage) + kWords * kXS + 4 * ty;
#pragma unroll
    for (int kk = 0; kk < kWords; ++kk) {
      const int4 xa = *reinterpret_cast<const int4*>(xs + kk * kXS);
      const int4 xb = *reinterpret_cast<const int4*>(xs + kk * kXS + 64);
      const int4 qa = *reinterpret_cast<const int4*>(qs + kk * kQS);
      const int xr[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      int qr[NQ] = {qa.x, qa.y, qa.z, qa.w};
      if constexpr (NQ == 8) {
        const int4 qb = *reinterpret_cast<const int4*>(qs + kk * kQS + 64);
        qr[4] = qb.x, qr[5] = qb.y, qr[6] = qb.z, qr[7] = qb.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NQ; ++j) acc[i][j] = __dp4a(xr[i], qr[j], acc[i][j]);
    }
  }
};

// ------------------------------------------------------------ bf16, wgmma

// The shared-memory matrix descriptor of a K-major tile under the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d = A[64 x 16] B[128 x 16]^T, bf16 operands from shared memory: the first
// step of a sum from zero, which reads nothing of d, so that d need not hold
// a value (nor a register) between two sums.
__device__ __forceinline__ void wgmma_m64n128k16_first(float (&d)[64], uint64_t a,
                                                       uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]),
        "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]),
        "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]),
        "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]),
        "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
        "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]),
        "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]),
        "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]),
        "=f"(d[62]), "=f"(d[63])
      : "l"(a), "l"(b)
      : "memory");
}

// d (+)= A[64 x 16] B[128 x 16]^T, bf16 operands from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Stage 128 rows x 64 dimensions (128 bytes) of bf16 `src` under the 128-byte
// swizzle: the 16-byte piece c of row r goes to r * 128 + ((c ^ (r & 7)) << 4).
__device__ __forceinline__ void stage_swizzled(uint32_t dst, const __nv_bfloat16* src,
                                               int row0, int row_limit, int d0, int d) {
  const int c = threadIdx.x & 7;
  const int rb = threadIdx.x >> 3;
  const bool col_ok = d0 + 8 * c < d;
  const __nv_bfloat16* p = src + (size_t)(row0 + rb) * d + d0 + 8 * c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rb + 32 * i;  // r & 7 == rb & 7
    const bool ok = col_ok && row0 + r < row_limit;
    cp_async16(dst + r * 128 + ((c ^ (rb & 7)) << 4), ok ? p + (size_t)32 * i * d : src,
               ok);
  }
}

struct MmaTile {
  using Storage = __nv_bfloat16;
  static constexpr int kQueries = 128;
  static constexpr int kDims = 64;
  static constexpr int kStageBytes = 2 * 128 * 128;  // queries, then rows
  static constexpr int kPerThread = 2;
  static constexpr int kGroups = 16, kRun = 2, kXor = 2, kSpan = 8;

  float acc[64];
  int lane, wq;  // wq: first query of the thread's two (the other is wq + 8)

  __device__ __forceinline__ MmaTile()
      : lane(threadIdx.x & 31), wq(16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2)) {}
  __device__ __forceinline__ int query(int jq) const { return wq + 8 * jq; }
  __device__ __forceinline__ int row_base(int g) const { return 8 * g + 2 * (lane & 3); }
  __device__ __forceinline__ int row_lane() const { return lane & 3; }
  static __device__ __forceinline__ int half_of(int g) { return g / 8; }
  __device__ __forceinline__ float value(int g, int l, int jq) const {
    return acc[4 * g + 2 * jq + l];
  }

  __device__ __forceinline__ void load(char* stage, const TileOperands<Storage>& op,
                                       int q0, int r0, int row_end, int d0) const {
    const uint32_t s = smem_u32(stage);
    stage_swizzled(s, op.q, q0, op.B, d0, op.d);
    stage_swizzled(s + 128 * 128, op.emb, r0, row_end, d0, op.d);
  }
  // The copies wrote through the generic proxy; wgmma reads through the
  // asynchronous one.
  __device__ __forceinline__ void arrived() const {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  // acc (+)= the stage's dimensions, 16 per instruction; `left` = d - d0.
  __device__ __forceinline__ void mma(const char* stage, bool first, int left) {
    const uint32_t s = smem_u32(stage);
    const uint64_t a = wgmma_desc(s + (threadIdx.x >> 7) * (64 * 128));
    const uint64_t b = wgmma_desc(s + 128 * 128);
    const int steps = left >= kDims ? kDims / 16 : (left + 15) / 16;
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int ks = 0; ks < steps; ++ks)  // 32 bytes along K: 2 in the address field
      wgmma_m64n128k16(acc, a + 2 * ks, b + 2 * ks, !(first && ks == 0));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  }
};

// MmaTile's layout over SplitOperands: K1's screen. A stage holds 64
// dimensions of the 128 queries once and of the chunk's 128 centroids three
// times, one swizzled block per piece (64 KB: three stages take one block an
// SM). Each stage's 3 x 64 products a (query, centroid) are summed from zero on
// the tensor cores into `part` (12 wgmma, the three pieces against the one
// staged query slice, lo first and hi last), then added to `acc` in IEEE fp32:
// the certificate of assign.cu bounds one stage's hardware sum, where the hi
// products pass through the last 4 steps only, not one sum of all 3d.
struct ScreenTile : MmaTile {
  static constexpr int kStageBytes = 4 * 128 * 128;  // queries, then hi, mid, lo

  float part[64];

  __device__ __forceinline__ void load(char* stage, const SplitOperands& op, int q0, int r0,
                                       int row_end, int d0) const {
    const uint32_t s = smem_u32(stage);
    stage_swizzled(s, op.q, q0, op.B, d0, op.d);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      stage_swizzled(s + (p + 1) * 128 * 128, op.pieces + (size_t)p * op.k * op.d, r0,
                     row_end, d0, op.d);
  }

  // acc (+)= the stage's dimensions of the three pieces; `left` = d - d0.
  __device__ __forceinline__ void mma(const char* stage, bool first, int left) {
    const uint32_t s = smem_u32(stage);
    const uint64_t a = wgmma_desc(s + (threadIdx.x >> 7) * (64 * 128));
    const int steps = left >= kDims ? kDims / 16 : (left + 15) / 16;
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(part[i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if (steps == kDims / 16) {  // a whole stage: the 12 wgmma unrolled
#pragma unroll
      for (int p = 2; p >= 0; --p) {  // lo, mid, hi: the large products go in last
        const uint64_t b = wgmma_desc(s + (p + 1) * 128 * 128);
#pragma unroll
        for (int ks = 0; ks < kDims / 16; ++ks)
          wgmma_m64n128k16(part, a + 2 * ks, b + 2 * ks, p < 2 || ks > 0);
      }
    } else {
#pragma unroll
      for (int p = 2; p >= 0; --p) {
        const uint64_t b = wgmma_desc(s + (p + 1) * 128 * 128);
        for (int ks = 0; ks < steps; ++ks)
          wgmma_m64n128k16(part, a + 2 * ks, b + 2 * ks, p < 2 || ks > 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(part[i])::"memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = first ? part[i] : __fadd_rn(acc[i], part[i]);
  }
};

// One step of K1's split of an f32 row value v into bf16 pieces: the piece
// RN_bf16(v), or 0 where that is under 2^-126 (no subnormal piece reaches the
// tensor cores: it stays in what is left), and what is left, v - piece, exact
// in fp32. Three steps give xh, xm, xl and the residual xr, x == xh + xm + xl
// + xr exactly; kernels/assign.py: split_f32_rows is the same in plain torch.
__device__ __forceinline__ float split_step(float v, float& piece) {
  float p = __bfloat162float(__float2bfloat16_rn(v));
  if (fabsf(p) < 0x1p-126f) p = 0.f;  // a NaN stays
  piece = p;
  return __fsub_rn(v, p);
}

// The bf16 bits of two pieces, each exactly a bf16 value: even index low.
__device__ __forceinline__ uint32_t pack_pieces(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// The pairs (row piece, centroid piece) K1's f32-row screen sums, in the order
// the tensor cores add them, the small products first: xm.hi, xh.mid, xh.hi
// (0 is xh / hi, 1 xm / mid). xl meets nothing, nor does the centroids' lo
// piece. The host computes the certificate from its own copy,
// kernels/assign.py: F32_SCREEN_PAIRS, and checks it against these
// (pqv_assign_f32_screen_pairs) before a launch.
constexpr int kScreenPairs = 3;
__host__ __device__ constexpr int screen_pair_row(int j) { return j == 0 ? 1 : 0; }
__host__ __device__ constexpr int screen_pair_centroid(int j) { return j == 1 ? 1 : 0; }

// ScreenTile's layout over SplitOperandsF32: K1's screen over f32 rows. A
// stage holds 64 dimensions of two bf16 pieces of the 128 rows (xh, xm) and
// of the chunk's 128 centroids (hi, mid), each a swizzled 16 KB block. The
// rows arrive raw: a thread copies the 32 bytes of 8 f32 values by two
// 16-byte cp.async into its own slot of the xh and the xm block, and once
// they have landed (arrived(), before the walk's barrier) splits them in
// registers and writes the pieces over them; no thread touches another's
// slot, so no barrier is added. No full-size copy of the rows in pieces
// exists anywhere. issue() starts the stage's 3 x 4 wgmma into `part` from
// zero (the order of screen_pair_*) and returns; retire() waits for them and
// adds `part` to `acc` in IEEE fp32, as ScreenTile does. walk_rows_lagged
// splits the next stage while the tensor cores run.
struct ScreenTileF32 : MmaTile {
  static constexpr int kBlock = 128 * 128;  // one swizzled piece block
  static constexpr int kStageBytes = 4 * kBlock;  // xh, xm, then hi, mid
  static constexpr int kStages = 3;

  float part[64];
  char* ring;    // the walk's ring
  int next = 0;  // its slot whose rows arrived() splits next

  __device__ __forceinline__ void load(char* stage, const SplitOperandsF32& op, int q0,
                                       int r0, int row_end, int d0) const {
    const uint32_t s = smem_u32(stage);
    const int c = threadIdx.x & 7, rb = threadIdx.x >> 3;
    const bool col_ok = d0 + 8 * c < op.d;
    const float* p = op.q + (size_t)(q0 + rb) * op.d + d0 + 8 * c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rb + 32 * i;  // r & 7 == rb & 7
      const bool ok = col_ok && q0 + r < op.B;
      const uint32_t slot = r * 128 + ((c ^ (rb & 7)) << 4);
      const float* src = ok ? p + (size_t)32 * i * op.d : op.q;
      cp_async16(s + slot, src, ok);
      cp_async16(s + kBlock + slot, ok ? src + 4 : op.q, ok);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
      stage_swizzled(s + (2 + q) * kBlock, op.pieces + (size_t)q * op.k * op.d, r0, row_end,
                     d0, op.d);
  }

  __device__ __forceinline__ void arrived() {
    char* stage = ring + next * kStageBytes;
    next = next + 1 == kStages ? 0 : next + 1;
    const int c = threadIdx.x & 7, rb = threadIdx.x >> 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      char* slot = stage + (rb + 32 * i) * 128 + ((c ^ (rb & 7)) << 4);
      const float4 a = *reinterpret_cast<const float4*>(slot);
      const float4 b = *reinterpret_cast<const float4*>(slot + kBlock);
      const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      float h[8], m[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) split_step(split_step(v[e], h[e]), m[e]);
      *reinterpret_cast<uint4*>(slot) =
          make_uint4(pack_pieces(h[0], h[1]), pack_pieces(h[2], h[3]),
                     pack_pieces(h[4], h[5]), pack_pieces(h[6], h[7]));
      *reinterpret_cast<uint4*>(slot + kBlock) =
          make_uint4(pack_pieces(m[0], m[1]), pack_pieces(m[2], m[3]),
                     pack_pieces(m[4], m[5]), pack_pieces(m[6], m[7]));
    }
    // the pieces were written through the generic proxy; wgmma reads through
    // the asynchronous one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  // Start part = the stage's 3 pairs of pieces; `left` = d - d0.
  __device__ __forceinline__ void issue(const char* stage, int left) {
    const uint32_t s = smem_u32(stage);
    const uint32_t half = (threadIdx.x >> 7) * (64 * 128);
    const int steps = left >= kDims ? kDims / 16 : (left + 15) / 16;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if (steps == kDims / 16) {  // a whole stage: the 12 wgmma unrolled
#pragma unroll
      for (int j = 0; j < kScreenPairs; ++j) {
        const uint64_t a = wgmma_desc(s + screen_pair_row(j) * kBlock + half);
        const uint64_t b = wgmma_desc(s + (2 + screen_pair_centroid(j)) * kBlock);
#pragma unroll
        for (int ks = 0; ks < kDims / 16; ++ks) {
          if (j == 0 && ks == 0)
            wgmma_m64n128k16_first(part, a, b);
          else
            wgmma_m64n128k16(part, a + 2 * ks, b + 2 * ks, 1);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kScreenPairs; ++j) {
        const uint64_t a = wgmma_desc(s + screen_pair_row(j) * kBlock + half);
        const uint64_t b = wgmma_desc(s + (2 + screen_pair_centroid(j)) * kBlock);
        if (j == 0) wgmma_m64n128k16_first(part, a, b);
        for (int ks = j == 0 ? 1 : 0; ks < steps; ++ks)
          wgmma_m64n128k16(part, a + 2 * ks, b + 2 * ks, 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }

  // Wait for the issued stage and add it: acc = part where `first`.
  __device__ __forceinline__ void retire(bool first) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(part[i])::"memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = first ? part[i] : __fadd_rn(acc[i], part[i]);
  }
};

// ------------------------------------------------------------ the walk

// Score rows [row_begin, row_end) against queries q0 .. q0 + kQueries - 1 in
// chunks of kTR rows through a ring of STAGES stages at `ring`. The epilogue
// sees `epi.begin(r0, slot)` before a chunk's first slice (at least one
// __syncthreads() follows before `chunk`) and `epi.chunk(tile, r0, slot)`
// once its sums are complete; slot alternates 0, 1. `op` is what the tile's
// load takes: TileOperands of its storage, WideningOperands or SplitOperands.
template <int STAGES, class Tile, class Operands, class Epilogue>
__device__ __forceinline__ void walk_rows(Tile& tile, const Operands& op, int q0,
                                          int row_begin, int row_end, char* ring,
                                          Epilogue& epi) {
  const int nk = (op.d + Tile::kDims - 1) / Tile::kDims;
  const int nchunks = (row_end - row_begin + kTR - 1) / kTR;
  int lc = 0, lk = 0, lslot = 0;  // next slice to load, and its stage
  auto fetch = [&]() {
    if (lc < nchunks) {
      tile.load(ring + lslot * Tile::kStageBytes, op, q0, row_begin + lc * kTR, row_end,
                lk * Tile::kDims);
      if (++lk == nk) {
        lk = 0;
        ++lc;
      }
    }
    cp_async_commit();
    lslot = lslot + 1 == STAGES ? 0 : lslot + 1;
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch();
  int slot = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int r0 = row_begin + c * kTR;
    epi.begin(r0, c & 1);
    for (int kb = 0; kb < nk; ++kb) {
      cp_async_wait<STAGES - 2>();
      tile.arrived();
      __syncthreads();  // the slice is visible; the stage read last is free
      fetch();
      tile.mma(ring + slot * Tile::kStageBytes, kb == 0, op.d - kb * Tile::kDims);
      slot = slot + 1 == STAGES ? 0 : slot + 1;
    }
    epi.chunk(tile, r0, c & 1);
  }
  cp_async_wait<0>();
}

// walk_rows for a tile whose products run while the next slice is prepared
// (ScreenTileF32): slice s's wgmma are issued after the barrier and retired
// in the next step, after the next slice has arrived() and before the
// barrier that lets the fetch reuse slice s's stage. A chunk's epilogue runs
// once its last slice is retired, so in the next chunk's first step (before
// that chunk's first retire overwrites acc) or after the loop.
template <int STAGES, class Tile, class Operands, class Epilogue>
__device__ __forceinline__ void walk_rows_lagged(Tile& tile, const Operands& op, int q0,
                                                 int row_begin, int row_end, char* ring,
                                                 Epilogue& epi) {
  const int nk = (op.d + Tile::kDims - 1) / Tile::kDims;
  const int nchunks = (row_end - row_begin + kTR - 1) / kTR;
  int lc = 0, lk = 0, lslot = 0;  // next slice to load, and its stage
  auto fetch = [&]() {
    if (lc < nchunks) {
      tile.load(ring + lslot * Tile::kStageBytes, op, q0, row_begin + lc * kTR, row_end,
                lk * Tile::kDims);
      if (++lk == nk) {
        lk = 0;
        ++lc;
      }
    }
    cp_async_commit();
    lslot = lslot + 1 == STAGES ? 0 : lslot + 1;
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch();
  int slot = 0;
  bool pending = false, pending_first = false;
  for (int c = 0; c < nchunks; ++c) {
    const int r0 = row_begin + c * kTR;
    epi.begin(r0, c & 1);
    for (int kb = 0; kb < nk; ++kb) {
      cp_async_wait<STAGES - 2>();
      tile.arrived();
      if (pending) {
        tile.retire(pending_first);
        if (kb == 0) epi.chunk(tile, r0 - kTR, (c - 1) & 1);
      }
      __syncthreads();  // the slice is visible; the stage read last is free
      fetch();
      tile.issue(ring + slot * Tile::kStageBytes, op.d - kb * Tile::kDims);
      pending = true;
      pending_first = kb == 0;
      slot = slot + 1 == STAGES ? 0 : slot + 1;
    }
  }
  if (pending) {
    tile.retire(pending_first);
    epi.chunk(tile, row_begin + (nchunks - 1) * kTR, (nchunks - 1) & 1);
  }
  cp_async_wait<0>();
}

// Which chunks of a range of at most 32 a walk scores: those whose bit is
// set. `next(c)` is the first scored chunk at or after c (32 when none is).
struct MaskChunks {
  uint32_t mask;
  __device__ __forceinline__ int next(int c) const {
    const uint32_t m = c < 32 ? mask >> c : 0u;
    return m ? c + __ffs(m) - 1 : 32;
  }
};

// walk_rows over the chunks `chunks` picks of rows [row_begin, row_end), at
// most 32 chunks: a chunk whose bit is clear is neither copied nor
// multiplied (K4 and K6: no query of the block probes a row of it). The
// epilogue's slot alternates over the scored chunks. A walk of its own, so
// that walk_rows compiles for K9, K5, K2 and K1 as it always did. A caller
// that walks again first makes sure, with a barrier, that every thread has
// left this walk: the next walk's first copies land in stages this one may
// still be reading.
template <int STAGES, class Tile, class Epilogue>
__device__ __forceinline__ void walk_chunks(Tile& tile,
                                            const TileOperands<typename Tile::Storage>& op,
                                            int q0, int row_begin, int row_end, char* ring,
                                            Epilogue& epi, const MaskChunks& chunks) {
  const int nk = (op.d + Tile::kDims - 1) / Tile::kDims;
  const int nchunks = (row_end - row_begin + kTR - 1) / kTR;
  int lc = chunks.next(0), lk = 0, lslot = 0;  // next slice to load, and its stage
  auto fetch = [&]() {
    if (lc < nchunks) {
      tile.load(ring + lslot * Tile::kStageBytes, op, q0, row_begin + lc * kTR, row_end,
                lk * Tile::kDims);
      if (++lk == nk) {
        lk = 0;
        lc = chunks.next(lc + 1);
      }
    }
    cp_async_commit();
    lslot = lslot + 1 == STAGES ? 0 : lslot + 1;
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch();
  int slot = 0, scored = 0;
  for (int c = chunks.next(0); c < nchunks; c = chunks.next(c + 1), ++scored) {
    const int r0 = row_begin + c * kTR;
    epi.begin(r0, scored & 1);
    for (int kb = 0; kb < nk; ++kb) {
      cp_async_wait<STAGES - 2>();
      tile.arrived();
      __syncthreads();  // the slice is visible; the stage read last is free
      fetch();
      tile.mma(ring + slot * Tile::kStageBytes, kb == 0, op.d - kb * Tile::kDims);
      slot = slot + 1 == STAGES ? 0 : slot + 1;
    }
    epi.chunk(tile, r0, scored & 1);
  }
  cp_async_wait<0>();
}

// walk_rows over `n` chunks that need not be neighbours: chunk c is the kTR
// rows from start(c), every one of them a row of the array. K7 and K8 score,
// for each slot of a slab block, the one 128-row lane group that folds into
// the block's slab (binscan.cu). The epilogue sees `epi.begin(c, r0, slot)`
// and `epi.chunk(tile, c, r0, slot)` as walk_rows' sees its two calls. A
// walk of its own, so that walk_rows compiles for K9, K5, K2 and K1 as it
// always did.
template <int STAGES, class Tile, class Start, class Epilogue>
__device__ __forceinline__ void walk_list(Tile& tile,
                                          const TileOperands<typename Tile::Storage>& op,
                                          int q0, int n, const Start& start, char* ring,
                                          Epilogue& epi) {
  const int nk = (op.d + Tile::kDims - 1) / Tile::kDims;
  int lc = 0, lk = 0, lslot = 0, lr0 = n > 0 ? start(0) : 0;  // next slice to load
  auto fetch = [&]() {
    if (lc < n) {
      tile.load(ring + lslot * Tile::kStageBytes, op, q0, lr0, lr0 + kTR, lk * Tile::kDims);
      if (++lk == nk) {
        lk = 0;
        if (++lc < n) lr0 = start(lc);
      }
    }
    cp_async_commit();
    lslot = lslot + 1 == STAGES ? 0 : lslot + 1;
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch();
  int slot = 0;
  for (int c = 0; c < n; ++c) {
    const int r0 = start(c);
    epi.begin(c, r0, c & 1);
    for (int kb = 0; kb < nk; ++kb) {
      cp_async_wait<STAGES - 2>();
      tile.arrived();
      __syncthreads();  // the slice is visible; the stage read last is free
      fetch();
      tile.mma(ring + slot * Tile::kStageBytes, kb == 0, op.d - kb * Tile::kDims);
      slot = slot + 1 == STAGES ? 0 : slot + 1;
    }
    epi.chunk(tile, c, r0, c & 1);
  }
  cp_async_wait<0>();
}

// Dynamic shared memory is aligned by hand: the swizzle wants 1024 bytes.
__device__ __forceinline__ char* align_ring(char* dyn) {
  const uint32_t a = smem_u32(dyn);
  return dyn + ((1024u - (a & 1023u)) & 1023u);
}

}  // namespace pqv
