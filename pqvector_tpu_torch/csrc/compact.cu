// K10 and K11: gather of selected row tiles (and their norms) into one
// contiguous block, for the probed-union `compact` mode.
//
// Replace pqvector_tpu/kernels/compact.py: pallas_tile_gather (_copy_kernel,
// a BlockSpec pipeline that stages each tile through fast memory) and
// pallas_tile_gather_dma (_dma_gather_kernel, direct asynchronous copies,
// eight in flight on a ring of semaphores).
//
// Both are pure copies: out[j] = in[sel[j]] for `cap` tiles of `seg` bytes,
// bit for bit, and sel may repeat or be out of order. Bytes bound them:
// each copied byte is read once and written once, so the least time is
// 2 * cap * seg / 3.35 TB/s.
//
// K10 stages through registers, the card's form of the TPU pipeline's copy
// through fast memory: block (j, y) copies a 32 KB slice of tile j with
// one 16-byte load and store per thread and step. Where a tile's bytes are
// no multiple of 16 (tiny tiles, odd widths) the same kernel runs on 4- or
// 2-byte words, so every tile size goes through it.
//
// K11 uses the asynchronous copy engine (TMA bulk copies). The card has no
// bulk copy from device memory to device memory, so shared memory is the
// relay: a ring of eight 16 KB stages. One thread per block walks its work
// items; for each it arms the stage's mbarrier with the byte count and
// issues cp.async.bulk global -> shared, and four items later it waits on
// that mbarrier and issues cp.async.bulk shared -> global. Before a stage is
// filled again it waits until the bulk store that last read it has
// finished reading (cp.async.bulk.wait_group.read). So four loads and four
// stores are in flight per block, eight copies on the ring, and no thread
// touches the data. Addresses and sizes must be multiples of 16 bytes; the
// wrapper checks that and takes K10 otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace pqv {

constexpr int kCopyThreads = 256;
constexpr int kCopySlice = 32768;  // bytes of a tile one K10 block copies

template <typename W>
__device__ __forceinline__ void copy_words(const char* src, char* dst,
                                           size_t begin, size_t end) {
  const W* s = reinterpret_cast<const W*>(src);
  W* o = reinterpret_cast<W*>(dst);
  for (size_t i = begin / sizeof(W) + threadIdx.x; i < end / sizeof(W);
       i += blockDim.x)
    o[i] = s[i];
}

// Block (j, y): bytes [y * kCopySlice, (y + 1) * kCopySlice) of selected tile
// j; the block of slice 0 also copies the tile's norms.
template <typename W, typename WS>
__global__ void __launch_bounds__(kCopyThreads)
    tile_gather_kernel(const char* __restrict__ emb, const char* __restrict__ sq,
                       const int* __restrict__ sel, char* __restrict__ emb_out,
                       char* __restrict__ sq_out, size_t seg, size_t seg_sq) {
  const int j = blockIdx.x;
  const size_t src = (size_t)sel[j];
  const size_t begin = (size_t)blockIdx.y * kCopySlice;
  const size_t end = min(begin + (size_t)kCopySlice, seg);
  copy_words<W>(emb + src * seg, emb_out + (size_t)j * seg, begin, end);
  if (blockIdx.y == 0)
    copy_words<WS>(sq + src * seg_sq, sq_out + (size_t)j * seg_sq, 0, seg_sq);
}

template <typename W>
int launch_gather(const char* emb, const char* sq, const int* sel, char* emb_out,
                  char* sq_out, int cap, size_t seg, size_t seg_sq, int word_sq,
                  cudaStream_t st) {
  dim3 grid(cap, (unsigned)((seg + kCopySlice - 1) / kCopySlice));
  if (word_sq == 16) {
    tile_gather_kernel<W, uint4><<<grid, kCopyThreads, 0, st>>>(
        emb, sq, sel, emb_out, sq_out, seg, seg_sq);
  } else {
    tile_gather_kernel<W, uint32_t><<<grid, kCopyThreads, 0, st>>>(
        emb, sq, sel, emb_out, sq_out, seg, seg_sq);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K11

constexpr int kRing = 8;         // stages of the ring
constexpr int kAhead = 4;        // loads issued before the first store
constexpr int kStageBytes = 16384;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Work item i of the launch: slice `c` of tile `j` of the rows (i below
// n_emb) or of the norms. Returns its source, destination and byte count.
struct CopyItem {
  const char* src;
  char* dst;
  uint32_t bytes;
};

__device__ __forceinline__ CopyItem copy_item(
    long long i, const char* emb, const char* sq, const int* sel, char* emb_out,
    char* sq_out, size_t seg, size_t seg_sq, int slices, int slices_sq,
    long long n_emb) {
  const bool rows = i < n_emb;
  const long long r = rows ? i : i - n_emb;
  const int per = rows ? slices : slices_sq;
  const size_t sz = rows ? seg : seg_sq;
  const int j = (int)(r / per);
  const size_t off = (size_t)(r % per) * kStageBytes;
  CopyItem it;
  it.src = (rows ? emb : sq) + (size_t)sel[j] * sz + off;
  it.dst = (rows ? emb_out : sq_out) + (size_t)j * sz + off;
  it.bytes = (uint32_t)min((size_t)kStageBytes, sz - off);
  return it;
}

__global__ void __launch_bounds__(32)
    tile_gather_dma_kernel(const char* __restrict__ emb,
                           const char* __restrict__ sq,
                           const int* __restrict__ sel, char* __restrict__ emb_out,
                           char* __restrict__ sq_out, int cap, size_t seg,
                           size_t seg_sq) {
  extern __shared__ __align__(128) char ring[];  // kRing stages
  __shared__ __align__(8) uint64_t bars[kRing];
  if (threadIdx.x != 0) return;  // one thread drives the copy engine
  for (int s = 0; s < kRing; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&bars[s]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const int slices = (int)((seg + kStageBytes - 1) / kStageBytes);
  const int slices_sq = (int)((seg_sq + kStageBytes - 1) / kStageBytes);
  const long long n_emb = (long long)cap * slices;
  const long long n_items = n_emb + (long long)cap * slices_sq;
  // this block's items: blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long mine =
      n_items > blockIdx.x ? (n_items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  for (long long m = 0; m < mine + kAhead; ++m) {
    if (m < mine) {
      const int s = (int)(m % kRing);
      // The store that read this stage was committed kRing items ago; at
      // most the kRing - kAhead - 1 newer ones may still be reading.
      if (m >= kRing)
        asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kRing - kAhead - 1)
                     : "memory");
      const CopyItem it =
          copy_item(blockIdx.x + m * gridDim.x, emb, sq, sel, emb_out, sq_out, seg,
                    seg_sq, slices, slices_sq, n_emb);
      const uint32_t bar = smem_addr(&bars[s]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(it.bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(ring + (size_t)s * kStageBytes)),
          "l"(it.src), "r"(it.bytes), "r"(bar)
          : "memory");
    }
    const long long c = m - kAhead;
    if (c >= 0) {
      const int s = (int)(c % kRing);
      mbar_wait(smem_addr(&bars[s]), (uint32_t)((c / kRing) & 1));
      const CopyItem it =
          copy_item(blockIdx.x + c * gridDim.x, emb, sq, sel, emb_out, sq_out, seg,
                    seg_sq, slices, slices_sq, n_emb);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(it.dst),
          "r"(smem_addr(ring + (size_t)s * kStageBytes)), "r"(it.bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace pqv

// K10. emb [nt * seg bytes], sq [nt * seg_sq bytes], sel [cap] int32 in
// [0, nt); emb_out [cap * seg], sq_out [cap * seg_sq]. seg and seg_sq are a
// tile's bytes in each array; word is the widest of 16, 4 and 2 bytes that
// divides seg and both base addresses of the rows, word_sq (16 or 4)
// likewise for the norms.
extern "C" int pqv_tile_gather(const void* emb, const void* sq, const int* sel,
                               void* emb_out, void* sq_out, int cap,
                               long long seg, long long seg_sq, int word,
                               int word_sq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const char* e = static_cast<const char*>(emb);
  const char* s = static_cast<const char*>(sq);
  char* eo = static_cast<char*>(emb_out);
  char* so = static_cast<char*>(sq_out);
  if (word == 16)
    return pqv::launch_gather<uint4>(e, s, sel, eo, so, cap, seg, seg_sq, word_sq,
                                      st);
  if (word == 4)
    return pqv::launch_gather<uint32_t>(e, s, sel, eo, so, cap, seg, seg_sq, word_sq,
                                      st);
  return pqv::launch_gather<uint16_t>(e, s, sel, eo, so, cap, seg, seg_sq, word_sq,
                                      st);
}

// K11. As K10, with seg, seg_sq and all four base addresses multiples of 16.
// `blocks` is the grid: one block per ring of stages.
extern "C" int pqv_tile_gather_dma(const void* emb, const void* sq, const int* sel,
                                   void* emb_out, void* sq_out, int cap,
                                   long long seg, long long seg_sq, int blocks,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = pqv::kRing * pqv::kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      pqv::tile_gather_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  pqv::tile_gather_dma_kernel<<<blocks, 32, smem, st>>>(
      static_cast<const char*>(emb), static_cast<const char*>(sq), sel,
      static_cast<char*>(emb_out), static_cast<char*>(sq_out), cap, (size_t)seg,
      (size_t)seg_sq);
  return (int)cudaGetLastError();
}
