// K1: nearest-centroid assignment, argmin_c |c|^2 - 2 x.c per row.
//
// Replaces pqvector_tpu/kernels/assign.py: pallas_assign (_assign_kernel).
// On the H100 it is the hot loop of the build: every Lloyd step on the
// training sample and the final pass over all rows.
//
// It runs on the score tile of score_tile.cuh with the data rows on the
// tile's query side: a block of 256 threads owns 128 rows of x and walks
// the centroids in chunks of 128, c_norm in the place of the rows' norms.
// The 128 x 128 sums of a chunk live in registers (an 8 centroids x 8 rows
// patch per thread, fed by 4 shared-memory loads per 64 FMAs from the
// cp.async ring); the epilogue keeps, per thread and owned row of x, a
// running (score, centroid) over the thread's 8 centroids of every chunk,
// and folds the 16 lanes that share the row once at the end with
// __shfl_xor, ordering on (score, id). A thread meets its centroids in
// ascending order and takes a new one only on a strict <, so ties keep the
// lowest centroid index, as jnp.argmin does. A block writes its 128 ids
// and nothing else: no score reaches shared or device memory, and no
// second launch merges anything. x is staged once per chunk (k / 128
// times, from L2 after the first); the centroids (512 KB at 1024 x 128)
// stay L2-resident. Centroids past k are masked by index; rows past n are
// zero-filled and never written.
//
// Scores are IEEE fp32: every sum adds its products in ascending dimension
// order with __fmaf_rn from zero, then __fmaf_rn(-2, sum, |c|^2), bit for
// bit what a sequential fmaf loop gives. Nothing rounds through TF32.
//
// The bf16-row form (pqv_assign_bf16) reads x as bf16, the resident matrix
// of a build under the bf16 wire, and widens each element to f32 as it is
// staged (WideningFmaTile); the centroids stay f32. Widening is exact, so its
// ids are those of the f32 form over x.float(), bit for bit, with no f32
// copy of x.
//
// What bounds it on the H100: the fp32 FMAs of the CUDA cores, 2 n k d
// operations against 67 TFLOP/s. At 16 words loaded per 64 FMAs the
// shared-memory pipe is as busy as the FMA pipe, so the loop runs at about
// half that peak, the rate of the library's own fp32 product on this card.
#include <math.h>

#include "score_tile.cuh"

namespace pqv {

template <class Tile>
struct ArgminFold {
  const float* c_norm;
  float* norms;  // shared, [2][kTR]: |c|^2 of this chunk and the next
  int k;
  float best[Tile::kPerThread];
  int best_i[Tile::kPerThread];

  __device__ __forceinline__ void begin(int r0, int slot) {
    if (threadIdx.x < kTR) {
      const int c = r0 + threadIdx.x;
      norms[slot * kTR + threadIdx.x] = c < k ? c_norm[c] : INFINITY;
    }
  }

  __device__ __forceinline__ void chunk(const Tile& t, int r0, int slot) {
    const float* cn = norms + slot * kTR;
#pragma unroll
    for (int g = 0; g < Tile::kGroups; ++g) {
#pragma unroll
      for (int l = 0; l < Tile::kRun; ++l) {
        const int r = t.row_base(g) + l;
        const int ci = r0 + r;
        const float s = cn[r];
        if (ci < k) {
#pragma unroll
          for (int jq = 0; jq < Tile::kPerThread; ++jq) {
            const float v = __fmaf_rn(-2.f, t.value(g, l, jq), s);
            if (v < best[jq]) {
              best[jq] = v;
              best_i[jq] = ci;
            }
          }
        }
      }
    }
  }

  // Join the lanes that hold a row's other centroids and write the ids.
  __device__ __forceinline__ void write(const Tile& t, int q0, int n, int* out) {
#pragma unroll
    for (int jq = 0; jq < Tile::kPerThread; ++jq) {
      float b = best[jq];
      int bi = best_i[jq];
#pragma unroll
      for (int x = 0; x < Tile::kXor; ++x) {
        const float ob = __shfl_xor_sync(kFull, b, 1 << x);
        const int oi = __shfl_xor_sync(kFull, bi, 1 << x);
        const bool take = (ob < b) | ((ob == b) & (oi < bi));
        b = take ? ob : b;
        bi = take ? oi : bi;
      }
      const int row = q0 + t.query(jq);
      if (t.row_lane() == 0 && row < n) out[row] = bi;
    }
  }
};

constexpr int kAssignStages = 3;

template <class Tile>
constexpr int assign_smem() {
  return 1024 + kAssignStages * Tile::kStageBytes + 2 * kTR * 4;
}

template <class Tile, class Operands>
__global__ void __launch_bounds__(kThreads, 2)
    assign_kernel(Operands op, const float* __restrict__ c_norm, int k,
                  int* __restrict__ out) {
  extern __shared__ char dyn[];
  char* ring = align_ring(dyn);
  Tile t;
  ArgminFold<Tile> epi;
  epi.c_norm = c_norm;
  epi.norms = reinterpret_cast<float*>(ring + kAssignStages * Tile::kStageBytes);
  epi.k = k;
#pragma unroll
  for (int jq = 0; jq < Tile::kPerThread; ++jq) {
    epi.best[jq] = INFINITY;
    epi.best_i[jq] = 0;
  }
  const int q0 = blockIdx.x * Tile::kQueries;
  walk_rows<kAssignStages>(t, op, q0, 0, k, ring, epi);
  epi.write(t, q0, op.B, out);
}

using AssignTile = FmaTile<float, 8>;
using AssignTileBf16 = WideningFmaTile<__nv_bfloat16, 8>;

template <class Tile, class Operands>
int launch_assign(Operands op, const float* c_norm, int k, int* out, void* stream) {
  auto kernel = assign_kernel<Tile, Operands>;
  constexpr int smem = assign_smem<Tile>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ceil_div(op.B, Tile::kQueries), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(op, c_norm, k, out);
  return (int)cudaGetLastError();
}

}  // namespace pqv

// x [n, d] f32, c [k, d] f32, c_norm [k] f32 -> out [n] int32.
extern "C" int pqv_assign(const float* x, const float* c, const float* c_norm,
                          int n, int d, int k, int* out, void* stream) {
  using namespace pqv;
  if (n <= 0) return 0;
  if (k < 1) return (int)cudaErrorInvalidValue;
  return launch_assign<AssignTile>(TileOperands<float>{x, c, n, d}, c_norm, k, out, stream);
}

// K1's bf16-row form: x [n, d] bf16 (uint16 bits), c [k, d] f32, c_norm [k]
// f32 -> out [n] int32; the ids of pqv_assign over the rows widened to f32.
extern "C" int pqv_assign_bf16(const void* x, const float* c, const float* c_norm,
                               int n, int d, int k, int* out, void* stream) {
  using namespace pqv;
  if (n <= 0) return 0;
  if (k < 1) return (int)cudaErrorInvalidValue;
  return launch_assign<AssignTileBf16>(
      WideningOperands<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(x), c, n, d},
      c_norm, k, out, stream);
}

// Dynamic shared memory of K1's launch, for the wrapper's own reckoning.
extern "C" int pqv_assign_smem() { return pqv::assign_smem<pqv::AssignTile>(); }
