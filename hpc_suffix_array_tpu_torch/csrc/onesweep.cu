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
//      from a global counter (not blockIdx), so a tile only ever waits on
//      tiles that are already running. Tile t covers elements [t * tile,
//      (t + 1) * tile), so the prefix follows tile order and the pass is
//      stable. Element j of the sorted tile with digit d lands at
//      digit_start[d] + tile_prefix[d] + (j - local_start[d]).
//
// What bounds the pass: device memory. It reads and writes every int32
// column once, 8 B per element per column: 24 B with three columns (6.4 GB
// at 2^28, 1.92 ms at 3.35 TB/s) and 32 B with four (2.56 ms). The first
// design ran a tile's steps one after another (load the key, rank,
// publish, look back, then load each other column and scatter it between
// two barriers), at a third of the bound. Measured on an H100 (PERF.md),
// three costs stand between a pass and its bound: the scatter, whose
// stores are contiguous only within a (tile, digit) run (16 elements in a
// 4,096-element tile with 8-bit digits) and cost about as much again as
// the same stores made contiguous, less in longer runs; the tile's own
// work (count, rank, look-back), which a block with no other tile to
// work on cannot hide; and the look-back, which the tiles' rate outruns,
// so a tile reads several predecessors' words. This design:
//
//  * takes the tile's shape (threads, items per thread), and so the blocks
//    an SM holds, from the column count, which sets the shared memory a
//    tile stages (Shape<cols>): long runs, one or two blocks an SM. No
//    shape has fewer than 4,096 elements, so the look-back status, sized
//    by 4,096-element tiles, fits every pass;
//  * runs a persistent grid (the blocks the card holds at once), each
//    block walking tiles from the counter. It stages a tile's columns with
//    cp.async into shared memory (evict-first in L2; its stores go out
//    evict-last, so a line that neighbouring tiles fill in pieces stays
//    in L2 until it is whole), one group a column,
//    the key's first. A block takes its next tile once its look-back is
//    done, and while it writes the current tile's columns out, it stages
//    the next tile's column into each buffer as soon as that buffer is
//    written: the next tile's reads run under the current one's stores,
//    and its key arrives first, so its counts can start. Element j of a
//    column sits at slot j + lead, where lead (0-3) is the column's
//    misalignment in elements: slot and element then share their place in
//    a 16-byte word, every whole chunk of 4 goes as one 16-byte copy, and
//    only the chunks at the tile's two ends go element by element. An MSD
//    bucket's slice at any offset takes this path, each column with its
//    own lead;
//  * counts early (Onesweep, Adinets and Merrill 2022; CUB's
//    BlockRadixRankMatchEarlyCounts): right after the key arrives, each
//    element's peers in its warp (the lanes with its digit) are found
//    with one __ballot_sync for each digit bit that varies in the warp
//    (no __match_any_sync), a digit's first lane adds their number to the
//    warp's shared histogram, and the tile publishes its counts
//    (AGGREGATE) before it ranks. It looks back only after the rank;
//  * ranks from those peers: an element's place in the sorted tile is its
//    warp's running count of the digit plus its lower peers. The tile
//    keeps only the inverse, the source slot of each sorted place (16
//    bits), and writes every column from its staged slot to its final
//    place;
//  * loads kLookStep predecessors' status words at once in the look-back,
//    not one dependent round trip per predecessor.
//
// Look-back: status[t * radix + d] is a 64-bit word, epoch (30 bits) |
// flag (2) | count (32). A tile publishes (AGGREGATE, its count) as soon
// as it has counted, and (INCLUSIVE, prefix + count) once its look-back is
// done; tile 0 publishes INCLUSIVE at once. One thread per digit walks
// back, adding AGGREGATE counts until it meets an INCLUSIVE one, and polls
// again where a word does not carry this pass's epoch. A word carries all
// it tells, so loads and stores are relaxed at GPU scope. The epoch tags
// each pass's words, so the status array and the per-pass tile counters
// are zeroed once per sort, not once per pass. Where the caller passes a
// counter, each tile adds the status words its look-backs examined: each
// word it took, and each poll of a word not yet published.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "radix_common.cuh"

using namespace sa_radix;

namespace {

constexpr int kHistItems = 16;                // digit_histograms' items
constexpr int kHistTile = kThreads * kHistItems;
constexpr int kMaxWords = 3;
constexpr int kMaxPasses = 96;                // 3 words x 32 bits, rbits 1
constexpr int kHistCells = 12 * kMaxRadix;    // largest [passes, radix]

constexpr unsigned long long kAggregate = 1;
constexpr unsigned long long kInclusive = 2;
// A look-back that polls this often traps, so a fault surfaces as a
// launch error instead of a hung card; a running predecessor publishes
// within microseconds.
constexpr long long kSpinLimit = 1LL << 28;
// Status words a look-back step loads at once.
constexpr int kLookStep = 4;
constexpr int kSmemPerSM = 228 * 1024;        // H100: shared memory an SM
constexpr int kSmemPerBlock = 1024;           // the system's share a block
constexpr unsigned kFull = 0xffffffffu;

// The tile of a pass on c columns: threads a block and items a thread,
// entry c - 1. Measured on an H100 (PERF.md): a larger tile gives longer
// (tile, digit) runs and fewer tiles to look back over, a smaller one
// more blocks an SM and a shorter wait: 6,144 elements won with 1 column
// (2 blocks an SM), 8,192 with 2 and 4 (2 and 1), 10,240 with 3 (1).
constexpr int kShapeThreads[4] = {384, 512, 640, 512};
constexpr int kShapeItems[4] = {16, 16, 16, 16};

template <int kCols>
struct Shape {
  static constexpr int threads = kShapeThreads[kCols - 1];
  static constexpr int items = kShapeItems[kCols - 1];
  static constexpr int tile = threads * items;
  static constexpr int warps = threads / 32;
  static constexpr int stride = tile + 4;     // a staged column's slots
  static constexpr int smem = kCols * stride * 4          // staged columns
                              + warps * kMaxRadix * 4     // s_count
                              + 2 * kMaxRadix * 4         // s_start, s_offset
                              + tile * 2;                 // s_src
  static constexpr int fit = kSmemPerSM / (smem + kSmemPerBlock);
  static constexpr int room = 65536 / (64 * threads);     // 64 registers
  static constexpr int blocks =                           // blocks an SM
      fit < room ? fit : room;
};

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

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// L2 policies of the pass's traffic. A staged read is the only read of
// its bytes: evict-first. An output line is written in pieces, a run's
// ends by neighbouring tiles: evict-last, so it stays in L2 until it is
// whole and goes to device memory once (measured on an H100: 4 columns
// at 2^28 5.07 -> 4.70 ms, PERF.md).
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void store_out(int32_t* p, int32_t v,
                                          unsigned long long policy) {
  asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;" ::"l"(p),
               "r"(v), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void copy16(int32_t* smem, const int32_t* gmem,
                                       unsigned long long policy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(s),
      "l"(gmem), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void copy4(int32_t* smem, const int32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The lanes of the warp whose digit equals d (d < 0: this lane alone):
// one ballot for each bit of `vary`, the digit bits on which the warp's
// elements differ; no __match_any_sync.
__device__ __forceinline__ unsigned digit_peers(int d, unsigned vary,
                                                int lane) {
  unsigned peers = __ballot_sync(kFull, d >= 0);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if ((vary >> b) & 1) {
      const bool bit = (d >> b) & 1;
      const unsigned m = __ballot_sync(kFull, bit);
      peers &= bit ? m : ~m;
    }
  }
  return d >= 0 ? peers : 1u << lane;
}

// The column's misalignment in elements: its element 0 sits at slot lead.
__device__ __forceinline__ int lead_of(const int32_t* col) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(col) >> 2) & 3);
}

// Requests elements [0, count) of src into slots [lead, lead + count) of
// dst: chunk q is slots [4q, 4q + 4), on a 16-byte boundary both in shared
// memory and in src.
template <int kThreadsP, int kTileP>
__device__ __forceinline__ void stage(int32_t* dst, const int32_t* src,
                                      int count, int lead, int tid,
                                      unsigned long long policy) {
  const int chunks = (count + lead + 3) >> 2;
#pragma unroll
  for (int i = 0; i < (kTileP / 4 + 1 + kThreadsP - 1) / kThreadsP; ++i) {
    const int q = i * kThreadsP + tid;
    if (q >= chunks) break;
    const int e = 4 * q - lead;               // element in slot 4q
    if (e >= 0 && e + 4 <= count) {
      copy16(dst + 4 * q, src + e, policy);
    } else {
      for (int r = 0; r < 4; ++r) {
        if (e + r >= 0 && e + r < count) copy4(dst + 4 * q + r, src + e + r);
      }
    }
  }
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

  const long long tiles = (n + kHistTile - 1) / kHistTile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * kHistTile;
    const int count =
        static_cast<int>(min(static_cast<long long>(kHistTile), n - base));
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w >= n_words) break;
      const int32_t* src = words.w[w] + base;
      uint32_t v[kHistItems];
#pragma unroll
      for (int k = 0; k < kHistItems; ++k) {
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
        for (int k = 0; k < kHistItems; ++k) {
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

template <int kCols>
__global__ void __launch_bounds__(Shape<kCols>::threads,
                                  Shape<kCols>::blocks)
onesweep_pass_kernel(Cols cols, int key_col, long long n, int shift,
                     int rbits, const int32_t* __restrict__ digit_starts,
                     unsigned long long* __restrict__ status,
                     int* __restrict__ tile_counter, unsigned epoch,
                     unsigned long long* __restrict__ lookback_reads) {
  using S = Shape<kCols>;
  constexpr int kT = S::threads;
  constexpr int kItemsP = S::items;
  constexpr int kTileP = S::tile;
  constexpr int kStride = S::stride;
  extern __shared__ int4 s_raw[];
  int32_t* s_col = reinterpret_cast<int32_t*>(s_raw);  // [kCols][kStride]
  int* s_count = s_col + kCols * kStride;      // [warps][kMaxRadix]
  int* s_start = s_count + S::warps * kMaxRadix;   // local digit starts
  int* s_offset = s_start + kMaxRadix;         // global place - local start
  uint16_t* s_src =
      reinterpret_cast<uint16_t*>(s_offset + kMaxRadix);  // [kTileP]
  __shared__ int s_tile;
  __shared__ int s_warp_sum[S::warps];
  __shared__ unsigned s_reads;

  const int radix = 1 << rbits;
  const unsigned mask = static_cast<unsigned>(radix - 1);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long tiles = (n + kTileP - 1) / kTileP;
  int lead[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) lead[c] = lead_of(cols.src[c]);
  const int32_t* key_src = cols.src[key_col];
  const int key_lead = lead_of(key_src);
  const int32_t* s_key = s_col + key_col * kStride + key_lead;
  int32_t* key_dst = cols.dst[key_col];
  const unsigned long long read_policy = evict_first_policy();
  const unsigned long long write_policy = evict_last_policy();

  // Requests every column of tile t, one group a column, the key's first.
  auto stage_tile = [&](int t) {
    const long long base = static_cast<long long>(t) * kTileP;
    const int count =
        static_cast<int>(min(static_cast<long long>(kTileP), n - base));
    stage<kT, kTileP>(s_col + key_col * kStride, key_src + base, count,
                      key_lead, tid, read_policy);
    commit_copies();
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c != key_col) {
        stage<kT, kTileP>(s_col + c * kStride, cols.src[c] + base, count,
                          lead[c], tid, read_policy);
        commit_copies();
      }
    }
  };

  if (tid == 0) {
    s_tile = atomicAdd(tile_counter, 1);
    s_reads = 0;
  }
  for (int i = tid; i < S::warps * kMaxRadix; i += kT) s_count[i] = 0;
  __syncthreads();
  int tile = s_tile;
  if (tile >= tiles) return;
  stage_tile(tile);
  const int digit_start = tid < radix ? digit_starts[tid] : 0;
  const int seg = warp * (kItemsP * 32);       // this warp's elements
  int* my_count = s_count + warp * kMaxRadix;
  const unsigned lower = (1u << lane) - 1u;

  // A block walks tiles from the counter. It takes its next tile while it
  // writes the current one, and stages the next tile's columns one by one
  // as the current one's are written out, so a tile's reads run under the
  // stores and the work of the tile before it.
  for (;;) {
    const long long base = static_cast<long long>(tile) * kTileP;
    const int count =
        static_cast<int>(min(static_cast<long long>(kTileP), n - base));
    wait_copies<kCols - 1>();                  // the key has arrived
    __syncthreads();

    // Early counts: a warp walks its segment 32 elements a step; each
    // element's peers (the lanes with its digit) are found once, and a
    // digit's first lane adds their number to the warp's histogram, so no
    // two lanes of an atomic share an address.
    unsigned dig[(kItemsP + 3) / 4];           // 8-bit digits, 4 a word
    unsigned any = 0;
    unsigned all = mask;
#pragma unroll
    for (int k = 0; k < kItemsP; ++k) {
      const int j = seg + k * 32 + lane;
      const unsigned d = j < count ? digit_of(s_key[j], shift, mask) : 0u;
      if (k % 4 == 0) dig[k / 4] = 0;
      dig[k / 4] |= d << (8 * (k % 4));
      if (j < count) {
        any |= d;
        all &= d;
      }
    }
    const unsigned vary =
        (__reduce_or_sync(kFull, any) ^ __reduce_and_sync(kFull, all)) &
        mask;
    unsigned peers[kItemsP];
#pragma unroll
    for (int k = 0; k < kItemsP; ++k) {
      const bool ok = seg + k * 32 + lane < count;
      const int d =
          ok ? static_cast<int>((dig[k / 4] >> (8 * (k % 4))) & 255) : -1;
      peers[k] = digit_peers(d, vary, lane);
      if (ok && (peers[k] & lower) == 0) {
        atomicAdd(my_count + d, __popc(peers[k]));
      }
    }
    __syncthreads();

    // Per digit (thread d): the warps' exclusive offsets and the tile's
    // count, published at once; then the digits' exclusive scan across
    // the block, one total a thread.
    int total = 0;
    if (tid < radix) {
#pragma unroll
      for (int w = 0; w < S::warps; ++w) {
        const int c = s_count[w * kMaxRadix + tid];
        s_count[w * kMaxRadix + tid] = total;
        total += c;
      }
      store_relaxed(status + static_cast<long long>(tile) * radix + tid,
                    status_word(epoch, tile == 0 ? kInclusive : kAggregate,
                                total));
    }
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_warp_sum[warp] = incl;
    __syncthreads();
    int start = incl - total;
    for (int w = 0; w < warp; ++w) start += s_warp_sum[w];
    if (tid < radix) {
      s_start[tid] = start;
#pragma unroll
      for (int w = 0; w < S::warps; ++w) {
        s_count[w * kMaxRadix + tid] += start;
      }
    }
    __syncthreads();

    // Rank, the same steps again: an element's place in the sorted tile
    // is its warp's running count of the digit plus its lower peers. Only
    // a digit's first lane touches the count; the sorted tile keeps the
    // source slot of each place.
#pragma unroll
    for (int k = 0; k < kItemsP; ++k) {
      const int j = seg + k * 32 + lane;
      const int d = static_cast<int>((dig[k / 4] >> (8 * (k % 4))) & 255);
      const int before = __popc(peers[k] & lower);
      int run = 0;
      if (j < count && before == 0) {
        run = my_count[d];
        my_count[d] = run + __popc(peers[k]);
      }
      run = __shfl_sync(kFull, run, __ffs(peers[k]) - 1);
      __syncwarp();
      if (j < count) s_src[run + before] = static_cast<uint16_t>(j);
    }

    // Look back (thread d), kLookStep predecessors a step: add AGGREGATE
    // counts up to the first INCLUSIVE word; poll again from a word that
    // is not yet published.
    int prefix = 0;
    unsigned reads = 0;
    if (tid < radix && tile > 0) {
      int t = tile - 1;
      long long spins = 0;
      for (;;) {
        unsigned long long v[kLookStep];
#pragma unroll
        for (int i = 0; i < kLookStep; ++i) {
          v[i] = t - i >= 0 ? load_relaxed(status +
                                           static_cast<long long>(t - i) *
                                               radix +
                                           tid)
                            : 0ull;
        }
        int used = 0;
        bool done = false;
        bool waiting = false;
#pragma unroll
        for (int i = 0; i < kLookStep; ++i) {
          if (done || waiting) continue;
          if (t - i < 0 || static_cast<unsigned>(v[i] >> 34) != epoch) {
            waiting = true;
            continue;
          }
          prefix += static_cast<int>(v[i] & 0xffffffffu);
          ++used;
          done = ((v[i] >> 32) & 3u) == kInclusive;
        }
        reads += used + waiting;
        if (done) break;
        t -= used;
        if (++spins > kSpinLimit) __trap();
      }
      store_relaxed(status + static_cast<long long>(tile) * radix + tid,
                    status_word(epoch, kInclusive, prefix + total));
    }
    if (tid < radix) s_offset[tid] = digit_start + prefix - start;
    if (lookback_reads != nullptr) {
      reads = __reduce_add_sync(kFull, reads);
      if (lane == 0 && reads != 0) atomicAdd(&s_reads, reads);
    }
    if (tid == 0) s_tile = atomicAdd(tile_counter, 1);
    wait_copies<0>();
    __syncthreads();
    const int next = s_tile;
    for (int i = tid; i < S::warps * kMaxRadix; i += kT) s_count[i] = 0;

    // Each sorted place's global place, then every column from its staged
    // slot there, the key's first; a column's buffer takes the next
    // tile's column as soon as every thread has written it.
    int to[kItemsP];
#pragma unroll
    for (int i = 0; i < kItemsP; ++i) {
      const int p = i * kT + tid;
      to[i] = -1;
      if (p < count) {
        const int32_t key = s_key[s_src[p]];
        to[i] = s_offset[digit_of(key, shift, mask)] + p;
        store_out(key_dst + to[i], key, write_policy);
      }
    }
    __syncthreads();
    const bool more = next < tiles;
    const long long next_base = static_cast<long long>(next) * kTileP;
    const int next_count =
        more ? static_cast<int>(
                   min(static_cast<long long>(kTileP), n - next_base))
             : 0;
    if (more) {
      stage<kT, kTileP>(s_col + key_col * kStride, key_src + next_base,
                        next_count, key_lead, tid, read_policy);
    }
    commit_copies();
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c == key_col) continue;
      const int32_t* s_c = s_col + c * kStride + lead[c];
#pragma unroll
      for (int i = 0; i < kItemsP; ++i) {
        if (to[i] >= 0) {
          store_out(cols.dst[c] + to[i], s_c[s_src[i * kT + tid]],
                    write_policy);
        }
      }
      __syncthreads();
      if (more) {
        stage<kT, kTileP>(s_col + c * kStride, cols.src[c] + next_base,
                          next_count, lead[c], tid, read_policy);
      }
      commit_copies();
    }
    if (!more) break;
    tile = next;
  }
  if (lookback_reads != nullptr && tid == 0) {
    atomicAdd(lookback_reads, static_cast<unsigned long long>(s_reads));
  }
}

template <int kCols>
cudaError_t launch_pass(const Cols& cols, int key_col, long long n,
                        int shift, int rbits, const int32_t* digit_starts,
                        unsigned long long* status, int* tile_counter,
                        unsigned epoch, unsigned long long* lookback_reads,
                        cudaStream_t stream) {
  using S = Shape<kCols>;
  const cudaError_t err = cudaFuncSetAttribute(
      onesweep_pass_kernel<kCols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  int sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  const long long tiles = (n + S::tile - 1) / S::tile;
  const long long grid =
      std::min(tiles, static_cast<long long>(sms) * S::blocks);
  onesweep_pass_kernel<kCols>
      <<<static_cast<unsigned>(grid), S::threads, S::smem, stream>>>(
          cols, key_col, n, shift, rbits, digit_starts, status, tile_counter,
          epoch, lookback_reads);
  return cudaGetLastError();
}

}  // namespace

// Elements a onesweep tile holds in a pass on n_cols columns (0 outside
// 1-4).
extern "C" int sa_onesweep_tile_elems(int n_cols) {
  switch (n_cols) {
    case 1: return Shape<1>::tile;
    case 2: return Shape<2>::tile;
    case 3: return Shape<3>::tile;
    case 4: return Shape<4>::tile;
    default: return 0;
  }
}

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
  const long long tiles = (n + kHistTile - 1) / kHistTile;
  const long long grid = std::min(tiles, 4LL * sms);
  digit_histograms_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      words, n_words, n, plan, rbits, static_cast<int32_t*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// One stable pass of columns s0..s{n_cols-1} -> d0..d{n_cols-1}, int32[n]
// each (4-byte aligned, any offset), by the rbits-bit digit of column
// key_col at shift. digit_starts int32[1 << rbits]: each digit's first
// global place (an exclusive scan of the pass's histogram). status: zeroed
// uint64[ceil(n / 4096) * 256], tile_counter: zeroed int32, both shared by
// the passes of one sort, each pass with its own counter and a larger
// epoch (1 <= epoch < 2^30). lookback_reads: null, or a uint64 the pass
// adds the status words its look-backs examined to. 1 <= n_cols <= 4,
// 1 <= rbits <= 8, 0 <= shift < 32, sources and destinations disjoint;
// unused pointers may be null.
extern "C" int sa_onesweep_pass(const void* s0, const void* s1,
                                const void* s2, const void* s3, void* d0,
                                void* d1, void* d2, void* d3, int n_cols,
                                int key_col, long long n, int shift,
                                int rbits, const void* digit_starts,
                                void* status, void* tile_counter,
                                unsigned epoch, void* lookback_reads,
                                void* stream) {
  if (epoch < 1 || epoch >= (1u << 30) || n_cols < 1 || n_cols > 4 ||
      key_col < 0 || key_col >= n_cols || rbits < 1 || rbits > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const Cols cols = make_cols(s0, s1, s2, s3, d0, d1, d2, d3);
  const auto* starts = static_cast<const int32_t*>(digit_starts);
  auto* words = static_cast<unsigned long long*>(status);
  auto* counter = static_cast<int*>(tile_counter);
  auto* reads = static_cast<unsigned long long*>(lookback_reads);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_cols) {
    case 1:
      err = launch_pass<1>(cols, key_col, n, shift, rbits, starts, words,
                           counter, epoch, reads, s);
      break;
    case 2:
      err = launch_pass<2>(cols, key_col, n, shift, rbits, starts, words,
                           counter, epoch, reads, s);
      break;
    case 3:
      err = launch_pass<3>(cols, key_col, n, shift, rbits, starts, words,
                           counter, epoch, reads, s);
      break;
    case 4:
      err = launch_pass<4>(cols, key_col, n, shift, rbits, starts, words,
                           counter, epoch, reads, s);
      break;
  }
  return static_cast<int>(err);
}
