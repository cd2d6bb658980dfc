// K10 and K11: gather of selected row tiles (and their norms) into one
// contiguous block, for the probed-union `compact` mode.
//
// Replace pqvector_tpu/kernels/compact.py: pallas_tile_gather (_copy_kernel,
// a BlockSpec pipeline that stages each tile through fast memory) and
// pallas_tile_gather_dma (_dma_gather_kernel, direct asynchronous copies,
// eight in flight on a ring of semaphores).
//
// Both are pure copies: out[j] = in[sel[j]] for `cap` tiles of `seg` bytes of
// rows and `seg_sq` bytes of norms, bit for bit; sel may repeat or be out of
// order. Bytes bound them: each byte is read once and written once, so the
// least time is 2 * cap * (seg + seg_sq) / 3.35 TB/s (0.156 ms for compact's
// selection on 1M x 128 bf16, 0.423 ms on 10M x 96). At 3.35 TB/s and 1-2 us
// of latency, Little's law asks for 25-50 KB of reads in flight on each of
// the 132 SMs; both designs keep several times that in flight.
//
// The work is one walk over items (Part, Item below). Each array's tiles are
// cut into items of at most kItem = 16 KB: a tile larger than that into
// slices, and smaller tiles (a 2 KB norm segment, tiny row tiles) `group`
// whole tiles to an item, whose copies land side by side in the output. So
// no item is a 2 KB copy of its own, and a norm segment is never an appendix
// of its tile. The entry points cut the parts (make_part), so a block finds
// its item with one 32-bit division.
//
// K10 copies through registers, one block of 256 threads an item. Each
// thread issues four independent 16-byte loads before it stores any of
// them; at 40 registers six blocks fit an SM, so 96 KB of reads are in
// flight there (capped at 32 registers for eight blocks it spilled 24 bytes
// and ran 2.5% slower). Source words are read once, by a load that does not
// allocate in L1 (ld.global.nc.L1::no_allocate); the stores keep L2's
// normal policy, since the extraction reads the block next. Tiles whose
// bytes or addresses are no multiple of 16 run the same items on 4- or
// 2-byte words. (A grid sized to the card, each block walking ~15 items,
// timed 3-6% slower on the device at compact's selections: a third of its
// blocks take one item more, so the last round runs a third full.)
//
// K11 uses the card's bulk-copy engine (cp.async.bulk; TMA without a tensor
// map). There is no bulk copy from device memory to device memory, so a
// ring of kRing = 8 stages of kItem bytes in shared memory is the relay, and
// no thread touches the data. One block an SM (no more than there are
// items) walks items b, b + grid, ... The roles are split so loads never
// wait behind stores: the producer warp arms a stage's `full` mbarrier with
// the item's bytes and issues its loads (one lane per tile of a group) as
// soon as the stage's `empty` mbarrier says it is free; the consumer lane
// waits on `full`, issues the item's one bulk store, and once the store
// before it has been read out of shared memory
// (cp.async.bulk.wait_group.read, which counts the consumer's own stores)
// arrives on that stage's `empty`. So up to 112 KB of loads are in flight
// on an SM. Addresses and sizes must be multiples of 16 bytes; the wrapper
// checks that and takes K10 otherwise. Item sizes of 16 or 32 KB and rings
// of 3 to 8 stages of 16 to 64 KB, one or two an SM, timed within 2% of
// each other on the device.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <climits>

namespace pqv {

constexpr size_t kItem = 16384;  // most bytes of an item; K11's stage

// One array's share of the walk: cap tiles of sz bytes from src (selected by
// sel) to dst, in items of at most kItem bytes.
struct Part {
  const char* src;
  char* dst;
  size_t sz;
  uint32_t items;
  int group;        // whole tiles an item copies (sz <= kItem), else 1
  uint32_t slices;  // items a tile is cut into (sz > kItem), else 1
};

// On the host, by the launch. items is no more than INT_MAX (checked there).
inline Part make_part(const char* src, char* dst, size_t sz, int cap) {
  Part p;
  p.src = src;
  p.dst = dst;
  p.sz = sz;
  if (sz <= kItem) {
    p.group = (int)(kItem / sz);
    p.slices = 1;
    p.items = (uint32_t)((cap + p.group - 1) / p.group);
  } else {
    p.group = 1;
    p.slices = (uint32_t)((sz + kItem - 1) / kItem);
    p.items = (uint32_t)std::min<size_t>((size_t)cap * p.slices, INT_MAX + size_t(1));
  }
  return p;
}

// Whether the two parts' items fit one launch's block indices.
inline bool parts_fit(const Part& rows, const Part& norms) {
  return (size_t)rows.items + norms.items <= (size_t)INT_MAX;
}

// Item r of a part: `tiles` selected tiles from j0 on, each giving
// `per_tile` bytes from byte `off` of its tile; they land side by side at
// dst + j0 * sz + off, `bytes` in all.
struct Item {
  int j0;
  int tiles;
  size_t off;
  uint32_t per_tile;
  uint32_t bytes;
};

__device__ __forceinline__ Item item_of(const Part p, int cap, uint32_t r) {
  Item it;
  const uint32_t t = r / p.slices;
  it.j0 = (int)(t * p.group);
  it.tiles = min(p.group, cap - it.j0);
  it.off = (size_t)(r - t * p.slices) * kItem;
  it.per_tile = (uint32_t)min(kItem, p.sz - it.off);
  it.bytes = it.per_tile * (uint32_t)it.tiles;
  return it;
}

// ---------------------------------------------------------------- K10

constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 4;  // independent loads a thread holds

// A source word, read once: the 16-byte form does not allocate in L1. (An
// L2 evict-first policy, ld.global.cs and a plain load timed the same,
// within 2%, at compact's selections.)
__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t load_once(const uint32_t* p) { return __ldg(p); }

__device__ __forceinline__ uint16_t load_once(const uint16_t* p) { return __ldg(p); }

// The block copies item r of part p in words of W: each round (one for a
// 16 KB item of 16-byte words), thread t loads words t, t + 256, t + 512,
// t + 768 of the item, then stores them.
template <typename W>
__device__ __forceinline__ void copy_item(const Part p, const int* __restrict__ sel,
                                          int cap, uint32_t r) {
  const Item it = item_of(p, cap, r);
  const uint32_t words = it.bytes / sizeof(W);
  const uint32_t tile_words = it.per_tile / sizeof(W);
  const W* first =
      reinterpret_cast<const W*>(p.src + (size_t)__ldg(sel + it.j0) * p.sz + it.off);
  W* dst = reinterpret_cast<W*>(p.dst + (size_t)it.j0 * p.sz + it.off);
  for (uint32_t base = threadIdx.x; base < words; base += kCopyThreads * kCopyUnroll) {
    W v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const uint32_t w = base + u * kCopyThreads;
      if (w < words) {
        const W* s = first + w;
        if (it.tiles > 1) {  // a group: word w lies in its k-th tile
          const uint32_t k = w / tile_words;
          s = reinterpret_cast<const W*>(p.src + (size_t)__ldg(sel + it.j0 + k) * p.sz) +
              (w - k * tile_words);
        }
        v[u] = load_once(s);
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const uint32_t w = base + u * kCopyThreads;
      if (w < words) dst[w] = v[u];
    }
  }
}

// Block b copies item b: the rows' items come first, then the norms'. A
// block's threads share nothing, so no barrier is needed.
template <typename W, typename WS>
__global__ void __launch_bounds__(kCopyThreads)
    tile_gather_kernel(const Part rows, const Part norms, const int* __restrict__ sel,
                       int cap) {
  const uint32_t i = blockIdx.x;
  if (i < rows.items)
    copy_item<W>(rows, sel, cap, i);
  else
    copy_item<WS>(norms, sel, cap, i - rows.items);
}

template <typename W>
int launch_gather(const Part& rows, const Part& norms, const int* sel, int cap,
                  int word_sq, cudaStream_t st) {
  const unsigned blocks = rows.items + norms.items;
  if (word_sq == 16)
    tile_gather_kernel<W, uint4><<<blocks, kCopyThreads, 0, st>>>(rows, norms, sel, cap);
  else
    tile_gather_kernel<W, uint32_t><<<blocks, kCopyThreads, 0, st>>>(rows, norms, sel, cap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K11

constexpr int kDmaThreads = 64;    // warp 0 loads, lane 0 of warp 1 stores
constexpr int kRing = 8;           // stages of kItem bytes a block
constexpr int kStoresReading = 1;  // stores left reading shared memory
constexpr int kMaxDevices = 64;
static_assert(kRing > kStoresReading, "a stage must be free to load into");

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

__global__ void __launch_bounds__(kDmaThreads)
    tile_gather_dma_kernel(const Part rows, const Part norms,
                           const int* __restrict__ sel, int cap) {
  extern __shared__ __align__(128) char buf[];  // kRing stages of kItem bytes
  __shared__ __align__(8) uint64_t full[kRing];
  __shared__ __align__(8) uint64_t empty[kRing];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[s]))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&empty[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const uint32_t n = rows.items + norms.items;
  // this block's items: blockIdx.x, blockIdx.x + gridDim.x, ...
  const uint32_t mine = blockIdx.x < n ? (n - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < 32) {
    // Producer warp: fill stage m % kRing with item m once its last store
    // has been read out.
    for (uint32_t m = 0; m < mine; ++m) {
      const int s = (int)(m % kRing);
      if (m >= kRing) mbar_wait(smem_addr(&empty[s]), (uint32_t)((m / kRing - 1) & 1));
      const uint32_t i = blockIdx.x + m * gridDim.x;
      const bool is_rows = i < rows.items;
      const Part p = is_rows ? rows : norms;
      const Item it = item_of(p, cap, is_rows ? i : i - rows.items);
      const uint32_t bar = smem_addr(&full[s]);
      if (lane == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                     "r"(it.bytes)
                     : "memory");
      const uint32_t to = smem_addr(buf + (size_t)s * kItem);
      for (int k = lane; k < it.tiles; k += 32) {
        const char* src = p.src + (size_t)__ldg(sel + it.j0 + k) * p.sz + it.off;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(to + (uint32_t)k * it.per_tile),
            "l"(src), "r"(it.per_tile), "r"(bar)
            : "memory");
      }
    }
  } else if (lane == 0) {
    // Consumer lane: store item m once it has landed; free the stage of the
    // store before it once that store has been read out.
    for (uint32_t m = 0; m < mine; ++m) {
      const int s = (int)(m % kRing);
      mbar_wait(smem_addr(&full[s]), (uint32_t)((m / kRing) & 1));
      const uint32_t i = blockIdx.x + m * gridDim.x;
      const bool is_rows = i < rows.items;
      const Part p = is_rows ? rows : norms;
      const Item it = item_of(p, cap, is_rows ? i : i - rows.items);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
              p.dst + (size_t)it.j0 * p.sz + it.off),
          "r"(smem_addr(buf + (size_t)s * kItem)), "r"(it.bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (m >= kStoresReading) {
        asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kStoresReading)
                     : "memory");
        const int freed = (int)((m - kStoresReading) % kRing);
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         smem_addr(&empty[freed]))
                     : "memory");
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Per device, set on its first K11 launch: the SM count, which sizes the
// grid; 0 until then, when the ring's shared-memory attribute is set. Two
// threads that meet here both write the same values.
std::atomic<int> dma_sms[kMaxDevices];

}  // namespace pqv

// K10. emb [nt * seg bytes], sq [nt * seg_sq bytes], sel [cap] int32 in
// [0, nt); emb_out [cap * seg], sq_out [cap * seg_sq]. seg and seg_sq are a
// tile's bytes in each array; word is the widest of 16, 4 and 2 bytes that
// divides seg and both base addresses of the rows, word_sq (16 or 4)
// likewise for the norms. The grid is one block an item.
extern "C" int pqv_tile_gather(const void* emb, const void* sq, const int* sel,
                               void* emb_out, void* sq_out, int cap, long long seg,
                               long long seg_sq, int word, int word_sq, void* stream) {
  if (cap <= 0) return (int)cudaErrorInvalidValue;
  const pqv::Part rows =
      pqv::make_part(static_cast<const char*>(emb), static_cast<char*>(emb_out), seg, cap);
  const pqv::Part norms =
      pqv::make_part(static_cast<const char*>(sq), static_cast<char*>(sq_out), seg_sq, cap);
  if (!pqv::parts_fit(rows, norms)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (word == 16) return pqv::launch_gather<uint4>(rows, norms, sel, cap, word_sq, st);
  if (word == 4) return pqv::launch_gather<uint32_t>(rows, norms, sel, cap, word_sq, st);
  return pqv::launch_gather<uint16_t>(rows, norms, sel, cap, word_sq, st);
}

// K11. As K10, with seg, seg_sq and all four base addresses multiples of 16.
// The grid is one block an SM, no more than there are items.
extern "C" int pqv_tile_gather_dma(const void* emb, const void* sq, const int* sel,
                                   void* emb_out, void* sq_out, int cap, long long seg,
                                   long long seg_sq, void* stream) {
  if (cap <= 0) return (int)cudaErrorInvalidValue;
  const pqv::Part rows =
      pqv::make_part(static_cast<const char*>(emb), static_cast<char*>(emb_out), seg, cap);
  const pqv::Part norms =
      pqv::make_part(static_cast<const char*>(sq), static_cast<char*>(sq_out), seg_sq, cap);
  if (!pqv::parts_fit(rows, norms)) return (int)cudaErrorInvalidValue;
  constexpr int smem = (int)(pqv::kItem * pqv::kRing);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= pqv::kMaxDevices) return (int)cudaErrorInvalidDevice;
  int sms = pqv::dma_sms[dev].load();
  if (sms == 0) {
    err = cudaFuncSetAttribute(pqv::tile_gather_dma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    pqv::dma_sms[dev].store(sms);
  }
  const unsigned blocks = std::min<unsigned>(rows.items + norms.items, (unsigned)sms);
  pqv::tile_gather_dma_kernel<<<blocks, pqv::kDmaThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(rows, norms, sel, cap);
  return (int)cudaGetLastError();
}
