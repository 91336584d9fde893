// Onesweep LSD radix sort for Hopper (sm_90a): the redesign of the radix
// pass that K2 + run_offsets + K3 (csrc/radix.cu) carried. It computes
// what the TPU's radix_pass_dma (experiments/radix_write.py:361: the
// Pallas block_digit_sort :213, XLA scans, place_runs :318) computes: one
// stable LSD pass. Two kernels:
//
//   digit_histograms: one read of the 1-3 key words gives the global digit
//      counts of every pass of the sort, hist[p, d] (the table the passes'
//      digit starts and the constant-digit skips are planned from). A CTA
//      walks tiles with block-private shared counters, at most 12 x 256;
//      each thread folds a run of equal digits among its items into one
//      shared atomic, so a constant digit costs one atomic per thread and
//      tile; at the end every nonzero counter goes to the global table
//      with one atomic.
//   onesweep_pass: one launch per executed pass. A CTA takes the next tile
//      of kTile elements from a global counter (not blockIdx), so a tile
//      only ever waits on tiles that are already running. It ranks the
//      tile's elements stably by digit (K2's rank: __match_any_sync and
//      per-warp running counts), publishes each digit's count, and finds
//      the count of that digit in all earlier tiles by decoupled look-back;
//      then every column goes once from its source, through shared memory
//      in sorted order, to its final place: element j of the sorted tile
//      with digit d lands at digit_start[d] + tile_prefix[d] +
//      (j - local_start[d]). Tile t covers elements [t*kTile, (t+1)*kTile),
//      so the prefix follows tile order and the pass is stable.
//
// Look-back: status[t * radix + d] is a 64-bit word, epoch (30 bits) |
// flag (2) | count (32). A tile publishes (AGGREGATE, its count) as soon
// as it has ranked, and (INCLUSIVE, prefix + count) once its look-back is
// done; tile 0 publishes INCLUSIVE at once. One thread per digit walks
// back, adding AGGREGATE counts until it meets an INCLUSIVE one, and spins
// while a word does not carry this pass's epoch. Stores are st.release.gpu
// and loads ld.acquire.gpu. The epoch tags each pass's words, so the
// status array and the per-pass tile counters are zeroed once per sort,
// not once per pass.
//
// What bounds it: device memory. A pass reads and writes every int32
// column once, 8 B per element per column: 24 B with three columns (6.4 GB
// at 2^28, 1.92 ms at 3.35 TB/s) and 32 B with four (2.56 ms), against
// K2 + K3's 16 B per column and the glue's six launches. Stores are
// contiguous only within a (tile, digit) run, about 16 elements with 8-bit
// digits in a 4096-element tile, so run edges land in partial 32-byte
// sectors; that, and the look-back's wait, keep a pass below the bound.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "radix_common.cuh"

using namespace sa_radix;

namespace {

constexpr int kItems = 16;                    // elements per thread
constexpr int kTile = kThreads * kItems;      // elements per tile
constexpr int kMaxWords = 3;
constexpr int kMaxPasses = 96;                // 3 words x 32 bits, rbits 1
constexpr int kHistCells = 12 * kMaxRadix;    // largest [passes, radix]

constexpr unsigned long long kAggregate = 1;
constexpr unsigned long long kInclusive = 2;
// A look-back that polls one status word this often traps, so a fault
// surfaces as a launch error instead of a hung card; a running
// predecessor publishes within microseconds.
constexpr long long kSpinLimit = 1LL << 28;

// Dynamic shared memory of onesweep_pass_kernel.
constexpr int kPassSmem = kTile * 4                        // s_buf
                          + kWarps * kMaxRadix * 4         // s_count
                          + 2 * kMaxRadix * 4              // s_start, s_offset
                          + kTile;                         // s_dig

struct Words {
  const int32_t* w[kMaxWords];
};

struct Plan {
  int n_passes;
  int lo[kMaxWords];              // word w's passes are the table rows
  int hi[kMaxWords];              // [lo[w], hi[w])
  unsigned char shift[kMaxPasses];
  unsigned char bits[kMaxPasses];
};

__device__ __forceinline__ unsigned long long status_word(
    unsigned epoch, unsigned long long flag, int count) {
  return (static_cast<unsigned long long>(epoch) << 34) | (flag << 32) |
         static_cast<unsigned>(count);
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__global__ void __launch_bounds__(kThreads)
digit_histograms_kernel(Words words, int n_words, long long n, Plan plan,
                        int rbits, int32_t* __restrict__ hist) {
  __shared__ int s_hist[kHistCells];
  __shared__ unsigned char s_shift[kMaxPasses];
  __shared__ unsigned char s_bits[kMaxPasses];
  const int radix = 1 << rbits;
  const int cells = plan.n_passes * radix;
  const int tid = threadIdx.x;
  for (int i = tid; i < cells; i += kThreads) s_hist[i] = 0;
  for (int p = tid; p < plan.n_passes; p += kThreads) {
    s_shift[p] = plan.shift[p];
    s_bits[p] = plan.bits[p];
  }
  __syncthreads();

  const long long tiles = (n + kTile - 1) / kTile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * kTile;
    const int count =
        static_cast<int>(min(static_cast<long long>(kTile), n - base));
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w >= n_words) break;
      const int32_t* src = words.w[w] + base;
      uint32_t v[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int j = k * kThreads + tid;
        v[k] = j < count ? static_cast<uint32_t>(src[j]) : 0u;
      }
      for (int p = plan.lo[w]; p < plan.hi[w]; ++p) {
        const int shift = s_shift[p];
        const uint32_t mask = (1u << s_bits[p]) - 1u;
        int* row = s_hist + p * radix;
        int run_d = 0;
        int run_c = 0;
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          if (k * kThreads + tid < count) {
            const int d = static_cast<int>((v[k] >> shift) & mask);
            if (run_c != 0 && d != run_d) {
              atomicAdd(row + run_d, run_c);
              run_c = 0;
            }
            run_d = d;
            ++run_c;
          }
        }
        if (run_c != 0) atomicAdd(row + run_d, run_c);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < cells; i += kThreads) {
    if (s_hist[i] != 0) atomicAdd(hist + i, s_hist[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
onesweep_pass_kernel(Cols cols, int n_cols, int key_col, long long n,
                     int shift, int rbits,
                     const int32_t* __restrict__ digit_starts,
                     unsigned long long* __restrict__ status,
                     int* __restrict__ tile_counter, unsigned epoch) {
  extern __shared__ int4 s_raw[];
  int32_t* s_buf = reinterpret_cast<int32_t*>(s_raw);      // [kTile]
  int* s_count = s_buf + kTile;             // [kWarps][kMaxRadix]
  int* s_start = s_count + kWarps * kMaxRadix;   // local digit starts
  int* s_offset = s_start + kMaxRadix;      // global place - local start
  unsigned char* s_dig =
      reinterpret_cast<unsigned char*>(s_offset + kMaxRadix);  // [kTile]
  __shared__ int s_tile;

  const int radix = 1 << rbits;
  const unsigned mask = static_cast<unsigned>(radix - 1);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(tile_counter, 1);
  for (int i = tid; i < kWarps * kMaxRadix; i += kThreads) s_count[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const long long base = static_cast<long long>(tile) * kTile;
  const int count =
      static_cast<int>(min(static_cast<long long>(kTile), n - base));
  const int seg = warp * (kItems * 32);     // this warp's elements
  const unsigned lower = (1u << lane) - 1u;

  // Local rank (K2's): a warp walks its segment 32 at a time; an element's
  // rank among equal digits before it in the warp is the running count
  // plus the lower lanes with the same digit. slot = digit << 16 | rank.
  const int32_t* keys = cols.src[key_col] + base;
  int32_t kv[kItems];
  int slot[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = seg + k * 32 + lane;
    kv[k] = j < count ? keys[j] : 0;
  }
  int* my_count = s_count + warp * kMaxRadix;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool ok = seg + k * 32 + lane < count;
    const int d = ok ? digit_of(kv[k], shift, mask) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = __popc(peers & lower);
    const int run = ok ? my_count[d] : 0;
    __syncwarp();
    if (ok && before == 0) my_count[d] = run + __popc(peers);
    __syncwarp();
    slot[k] = ok ? (d << 16) | (run + before) : -1;
  }
  __syncthreads();

  // Per digit (thread d): the warps' exclusive offsets, the tile's count,
  // which is published at once, then the look-back for the prefix.
  unsigned long long* my_status =
      status + static_cast<long long>(tile) * radix + tid;
  int prefix = 0;
  int start = 0;
  if (tid < radix) {
    start = digit_starts[tid];
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w * kMaxRadix + tid];
      s_count[w * kMaxRadix + tid] = total;
      total += c;
    }
    s_start[tid] = total;
    store_release(my_status, status_word(epoch, tile == 0 ? kInclusive
                                                          : kAggregate,
                                         total));
    if (tile > 0) {
      for (int t = tile - 1; t >= 0; --t) {
        const unsigned long long* p =
            status + static_cast<long long>(t) * radix + tid;
        unsigned long long v;
        long long spins = 0;
        do {
          v = load_acquire(p);
          if (++spins > kSpinLimit) __trap();
        } while (static_cast<unsigned>(v >> 34) != epoch);
        prefix += static_cast<int>(v & 0xffffffffu);
        if (((v >> 32) & 3u) == kInclusive) break;
      }
      store_release(my_status, status_word(epoch, kInclusive,
                                           prefix + total));
    }
  }
  __syncthreads();
  if (warp == 0) warp_exclusive_scan(s_start, radix, lane);
  __syncthreads();
  if (tid < radix) s_offset[tid] = start + prefix - s_start[tid];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (slot[k] >= 0) {
      const int d = slot[k] >> 16;
      const int to = s_start[d] + my_count[d] + (slot[k] & 0xffff);
      s_dig[to] = static_cast<unsigned char>(d);
      slot[k] = to;
    }
  }
  __syncthreads();

  // Global place of each sorted slot this thread writes.
  int to[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = i * kThreads + tid;
    to[i] = j < count ? s_offset[s_dig[j]] + j : -1;
  }
  for (int c = 0; c < n_cols; ++c) {
    if (c == key_col) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (slot[k] >= 0) s_buf[slot[k]] = kv[k];
      }
    } else {
      const int32_t* src = cols.src[c] + base;
      int32_t v[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        v[k] = slot[k] >= 0 ? src[seg + k * 32 + lane] : 0;
      }
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (slot[k] >= 0) s_buf[slot[k]] = v[k];
      }
    }
    __syncthreads();
    int32_t* dst = cols.dst[c];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (to[i] >= 0) dst[to[i]] = s_buf[i * kThreads + tid];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int sa_onesweep_tile_elems() { return kTile; }

// Global digit counts of every pass: hist int32[n_passes, 1 << rbits],
// zeroed by the caller; row p counts the pass_bits[p]-bit digit of word
// pass_word[p] at pass_shift[p]. Words w0..w{n_words-1} are int32[n];
// 1 <= n_words <= 3, 1 <= rbits <= 8, each pass's bits in [1, rbits] and
// a word's passes on adjacent rows. Returns a CUDA error code.
extern "C" int sa_digit_histograms(const void* w0, const void* w1,
                                   const void* w2, int n_words, long long n,
                                   int n_passes, const int* pass_word,
                                   const int* pass_shift,
                                   const int* pass_bits, int rbits,
                                   void* hist, void* stream) {
  if (n_words < 1 || n_words > kMaxWords || n_passes < 1 ||
      n_passes > kMaxPasses || rbits < 1 || rbits > 8 ||
      (n_passes << rbits) > kHistCells) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan;
  plan.n_passes = n_passes;
  for (int w = 0; w < kMaxWords; ++w) plan.lo[w] = plan.hi[w] = 0;
  for (int p = 0; p < n_passes; ++p) {
    const int w = pass_word[p];
    const int bits = pass_bits[p];
    const int shift = pass_shift[p];
    if (w < 0 || w >= n_words || bits < 1 || bits > rbits || shift < 0 ||
        shift + bits > 32) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (plan.lo[w] == plan.hi[w]) {
      plan.lo[w] = p;
    } else if (plan.hi[w] != p) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    plan.hi[w] = p + 1;
    plan.shift[p] = static_cast<unsigned char>(shift);
    plan.bits[p] = static_cast<unsigned char>(bits);
  }
  if (n <= 0) return 0;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  Words words;
  words.w[0] = static_cast<const int32_t*>(w0);
  words.w[1] = static_cast<const int32_t*>(w1);
  words.w[2] = static_cast<const int32_t*>(w2);
  const long long tiles = (n + kTile - 1) / kTile;
  const long long grid = std::min(tiles, 4LL * sms);
  digit_histograms_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      words, n_words, n, plan, rbits, static_cast<int32_t*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// One stable pass of columns s0..s{n_cols-1} -> d0..d{n_cols-1}, int32[n]
// each, by the rbits-bit digit of column key_col at shift. digit_starts
// int32[1 << rbits]: each digit's first global place (an exclusive scan of
// the pass's histogram). status: zeroed uint64[ceil(n / kTile) * 256],
// tile_counter: zeroed int32, both shared by the passes of one sort, each
// pass with its own counter and a larger epoch (1 <= epoch < 2^30).
// 1 <= n_cols <= 4, 1 <= rbits <= 8, 0 <= shift < 32, sources and
// destinations disjoint; unused pointers may be null.
extern "C" int sa_onesweep_pass(const void* s0, const void* s1,
                                const void* s2, const void* s3, void* d0,
                                void* d1, void* d2, void* d3, int n_cols,
                                int key_col, long long n, int shift,
                                int rbits, const void* digit_starts,
                                void* status, void* tile_counter,
                                unsigned epoch, void* stream) {
  if (epoch < 1 || epoch >= (1u << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  if (kPassSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        onesweep_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kPassSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles = (n + kTile - 1) / kTile;
  onesweep_pass_kernel<<<static_cast<unsigned>(tiles), kThreads, kPassSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      make_cols(s0, s1, s2, s3, d0, d1, d2, d3), n_cols, key_col, n, shift,
      rbits, static_cast<const int32_t*>(digit_starts),
      static_cast<unsigned long long*>(status),
      static_cast<int*>(tile_counter), epoch);
  return static_cast<int>(cudaGetLastError());
}
