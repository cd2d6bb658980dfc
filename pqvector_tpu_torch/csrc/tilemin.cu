// K9: per-tile minimum of |x|^2 - 2 q.x over contiguous row tiles, values
// only (pass 1 of the certified-exact scan).
//
// Replaces pqvector_tpu/kernels/tilemin.py: pallas_tile_min
// (_tilemin_kernel).
//
// The TPU kernel scores a [bt, ct * tile] block on the matrix unit and folds
// each tile's lane group to its minimum before the block leaves fast
// memory. Here a block of 256 threads owns 128 queries (64 for a small
// batch) and a run of rows. It streams 64-row chunks of the rows, 32
// dimensions at a time, through shared memory; each thread keeps a patch of
// 4 rows x 8 (or 4) queries of sums in registers; and the chunk's scores go
// to shared memory only to be folded: a segmented warp-shuffle minimum
// gives each (query, tile) its value, carried in a register across chunks
// where a tile is longer than a chunk. The [B, n_pad] score block never
// exists in device memory. Tiles are independent, so no state crosses
// blocks: no atomics, no merge launch.
//
// The score is the TPU kernel's: q2 = (-2 q) rounded to the storage dtype
// by the caller, dot(q2, x) accumulated in fp32 in ascending dimension
// order with __fmaf_rn, then + |x|^2 with __fadd_rn. bf16 operands are
// widened to fp32, so their products are exact. A pad row is all zeros, so
// its score is its norm: +3e38 or +inf, never NaN, and a tile of pad rows
// only returns that sentinel.
//
// What bounds it on the H100: fp32 FMA on the CUDA cores, 2 B n_pad d
// operations against 67 TFLOP/s. Rows and queries are staged with a row
// stride of 36 floats, so a thread reads four dimensions of a row or a
// query with one 16-byte load free of bank conflicts: 12 loads feed 128
// FMAs (a first design with a 4 x 4 patch and scalar row loads, 5 loads for
// 16 FMAs, was slower). Shared-memory loads still bound it: a 16-byte load
// occupies the load unit for four cycles even where lanes share an
// address, so four warps' 12 loads take 192 cycles against 128 for their
// FMAs. An 8 x 8 patch or a tensor-core tile is the way on. The rows are
// read once for every 128 queries. No tensor cores (the f32 score must be
// IEEE fp32), no TMA yet.
#include "common.cuh"

namespace pqv {

constexpr int kTDK = 32;           // dimensions staged per step
constexpr int kTStride = kTDK + 4; // floats per staged row: 16-byte aligned,
                                   // and 36 r mod 32 spreads rows over banks

// NQ queries per thread: the block owns 16 * NQ queries.
template <typename T, int NQ>
__global__ void __launch_bounds__(kThreads, 2)
    tile_min_kernel(const T* __restrict__ q2, const T* __restrict__ emb,
                    const float* __restrict__ emb_sq, float* __restrict__ out,
                    int B, int d, int n_pad, int tile, int run) {
  constexpr int TQ = 16 * NQ;
  constexpr int kStage = (kRC + TQ) * kTStride;  // staged rows, then queries
  constexpr int kPart = TQ * (kRC + 1);          // the chunk's scores
  __shared__ __align__(16) float smem[kStage > kPart ? kStage : kPart];
  float(*xs)[kTStride] = reinterpret_cast<float(*)[kTStride]>(smem);
  float(*qs)[kTStride] =
      reinterpret_cast<float(*)[kTStride]>(smem + kRC * kTStride);
  // the scores overlay the staging area once the sums are done
  float(*part)[kRC + 1] = reinterpret_cast<float(*)[kRC + 1]>(smem);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int rl = t & 15;  // rows rl, rl + 16, rl + 32, rl + 48 of the chunk
  const int g = t >> 4;   // queries NQ g .. NQ g + NQ - 1 of the block
  const int q0 = blockIdx.y * TQ;
  const int nt = n_pad / tile;
  const int row_begin = blockIdx.x * run;
  const int row_end = min(row_begin + run, n_pad);
  const float inf = __int_as_float(0x7f800000);
  // Warp w folds queries w, w + 8, ...; a tile longer than a chunk carries
  // its minimum here from chunk to chunk (only that warp's lane 0 touches
  // a query's slot).
  __shared__ float carry[TQ];
  for (int e = t; e < TQ; e += kThreads) carry[e] = inf;
  const int seg = tile < 32 ? tile : 32;  // lanes that share one tile

  for (int r0 = row_begin; r0 < row_end; r0 += kRC) {
    float acc[4][NQ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NQ; ++j) acc[i][j] = 0.f;
    for (int d0 = 0; d0 < d; d0 += kTDK) {
      for (int e = t; e < kRC * kTDK; e += kThreads) {
        const int rr = e / kTDK, cc = e % kTDK;
        const int row = r0 + rr, col = d0 + cc;
        xs[rr][cc] = (row < row_end && col < d)
                         ? to_f32(emb[(size_t)row * d + col])
                         : 0.f;
      }
      for (int e = t; e < TQ * kTDK; e += kThreads) {
        const int qq = e / kTDK, cc = e % kTDK;
        const int b = q0 + qq, col = d0 + cc;
        qs[qq][cc] = (b < B && col < d) ? to_f32(q2[(size_t)b * d + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int c4 = 0; c4 < kTDK; c4 += 4) {
        float4 xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xv[i] = *reinterpret_cast<const float4*>(&xs[rl + 16 * i][c4]);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float4 qv = *reinterpret_cast<const float4*>(&qs[NQ * g + j][c4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a = acc[i][j];
            a = __fmaf_rn(xv[i].x, qv.x, a);
            a = __fmaf_rn(xv[i].y, qv.y, a);
            a = __fmaf_rn(xv[i].z, qv.z, a);
            a = __fmaf_rn(xv[i].w, qv.w, a);
            acc[i][j] = a;
          }
        }
      }
      __syncthreads();  // also frees the staging area for the scores
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + rl + 16 * i;
      const bool ok = row < row_end;
      const float sq = ok ? emb_sq[row] : inf;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
        part[NQ * g + j][rl + 16 * i] = ok ? __fadd_rn(acc[i][j], sq) : inf;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TQ / kWarps; ++i) {
      const int qq = w + kWarps * i;
      const int b = q0 + qq;
      if (b >= B) continue;  // uniform across the warp
#pragma unroll
      for (int c0 = 0; c0 < kRC; c0 += 32) {
        float v = part[qq][c0 + lane];
        for (int off = seg >> 1; off > 0; off >>= 1)
          v = fminf(v, __shfl_xor_sync(kFull, v, off));
        const int row = r0 + c0 + lane;
        if (tile <= 32) {
          if (lane % tile == 0 && row < row_end)
            out[(size_t)b * nt + row / tile] = v;
        } else if (lane == 0) {
          v = fminf(carry[qq], v);
          if ((r0 + c0 + 32) % tile == 0) {  // the tile ends with this half-chunk
            out[(size_t)b * nt + (r0 + c0) / tile] = v;
            v = inf;
          }
          carry[qq] = v;
        }
      }
    }
    __syncthreads();  // the scores are the staging area of the next chunk
  }
}

template <typename T>
int launch_tile_min(const void* q2, const void* emb, const float* emb_sq,
                    float* out, int B, int d, int n_pad, int tile, int run,
                    cudaStream_t st) {
  const T* q = static_cast<const T*>(q2);
  const T* e = static_cast<const T*>(emb);
  if (B > 64) {
    dim3 grid(ceil_div(n_pad, run), ceil_div(B, 128));
    tile_min_kernel<T, 8><<<grid, kThreads, 0, st>>>(q, e, emb_sq, out, B, d,
                                                     n_pad, tile, run);
  } else {
    dim3 grid(ceil_div(n_pad, run), 1);
    tile_min_kernel<T, 4><<<grid, kThreads, 0, st>>>(q, e, emb_sq, out, B, d,
                                                     n_pad, tile, run);
  }
  return (int)cudaGetLastError();
}

}  // namespace pqv

// q2 [B, d] = (-2 q) in emb's dtype, emb [n_pad, d] (bf16 when is_bf16),
// emb_sq [n_pad] f32; out [B, n_pad / tile] f32. tile is a power of two that
// divides n_pad; run, the rows one block owns, is a multiple of
// max(tile, 64).
extern "C" int pqv_tile_min(const void* q2, const void* emb, const float* emb_sq,
                            int B, int d, int n_pad, int tile, int run,
                            int is_bf16, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return pqv::launch_tile_min<__nv_bfloat16>(q2, emb, emb_sq, out, B, d, n_pad,
                                               tile, run, st);
  return pqv::launch_tile_min<float>(q2, emb, emb_sq, out, B, d, n_pad, tile, run,
                                     st);
}
