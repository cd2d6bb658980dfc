// K1: nearest-centroid assignment, argmin_c |c|^2 - 2 x.c per row.
//
// Replaces pqvector_tpu/kernels/assign.py: pallas_assign (_assign_kernel).
// On the H100 it is the hot loop of the build: every Lloyd step on the
// training sample and the final pass over all rows.
//
// Threads own rows: a block of 128 threads takes 128 rows. Centroids are
// staged through shared memory 64 at a time, and both the rows and the
// centroids 32 dimensions at a time; each thread keeps 64 fp32 scores in
// registers, then folds them into its running argmin with a strict <, so
// ties keep the lowest centroid index, as jnp.argmin does. Scores are IEEE
// fp32 FMA; nothing rounds through TF32.
//
// What bounds it on the H100: the FMA issue rate of the CUDA cores (the
// product is n*k*d FMAs, 134 G at 1M x 1024 x 128), plus re-reading the
// rows once per 64 centroids (k/64 passes over x, served mostly from L2).
// No tensor cores yet: a wgmma score tile with the argmin in its epilogue
// is the later, fast form.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;  // rows per block, one per thread
constexpr int kCC = 64;     // centroids per staged chunk
constexpr int kDK = 32;     // dimensions per staged chunk

__global__ void __launch_bounds__(kRows)
    assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                  const float* __restrict__ c_norm, int n, int d, int k,
                  int* __restrict__ out) {
  __shared__ float xs[kDK][kRows + 1];
  __shared__ __align__(16) float cs[kDK][kCC];
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  float best = INFINITY;
  int best_i = 0;
  for (int c0 = 0; c0 < k; c0 += kCC) {
    float acc[kCC];
#pragma unroll
    for (int j = 0; j < kCC; ++j) acc[j] = 0.f;
    for (int d0 = 0; d0 < d; d0 += kDK) {
      for (int e = t; e < kRows * kDK; e += kRows) {
        const int rr = e / kDK, cc = e % kDK;
        const int row = row0 + rr, col = d0 + cc;
        xs[cc][rr] = (row < n && col < d) ? x[(size_t)row * d + col] : 0.f;
      }
      for (int e = t; e < kCC * kDK; e += kRows) {
        const int cj = e / kDK, cc = e % kDK;
        const int ci = c0 + cj, col = d0 + cc;
        cs[cc][cj] = (ci < k && col < d) ? c[(size_t)ci * d + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < kDK; ++cc) {
        const float xv = xs[cc][t];
        const float4* cv = reinterpret_cast<const float4*>(cs[cc]);
#pragma unroll
        for (int j = 0; j < kCC / 4; ++j) {
          const float4 v = cv[j];
          acc[4 * j + 0] = fmaf(xv, v.x, acc[4 * j + 0]);
          acc[4 * j + 1] = fmaf(xv, v.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(xv, v.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(xv, v.w, acc[4 * j + 3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kCC; ++j) {
      const int ci = c0 + j;
      if (ci < k) {
        const float v = c_norm[ci] - 2.f * acc[j];
        if (v < best) {
          best = v;
          best_i = ci;
        }
      }
    }
  }
  if (row0 + t < n) out[row0 + t] = best_i;
}

}  // namespace

// x [n, d] f32, c [k, d] f32, c_norm [k] f32 -> out [n] int32.
extern "C" int pqv_assign(const float* x, const float* c, const float* c_norm,
                          int n, int d, int k, int* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + kRows - 1) / kRows;
    assign_kernel<<<blocks, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
        x, c, c_norm, n, d, k, out);
  }
  return (int)cudaGetLastError();
}
