// One stable LSD radix pass in two kernels, the Hopper (sm_90a) port of
// the TPU kernels experiments/radix_write.py::block_digit_sort (K2) and
// ::place_runs (K3). Between them, plain PyTorch turns the per-block
// digit histogram into run offsets (kernels/radix.py::run_offsets), as
// XLA did between the two Pallas calls (radix_pass_dma).
//
//   K2 block_digit_sort: per block of kBlock elements, a stable sort of up
//      to kMaxCols int32 columns by the rbits-bit digit of column key_col
//      at `shift`, written to staging, plus the block's digit histogram
//      hist[b, d].
//   K3 place_runs: copies each (block, digit) run of the staging to its
//      global offset: element j of block b with digit d goes to
//      run_dst[b, d] + j - run_src[b, d].
//
// Digits are taken from the key as uint32, so the pass orders keys as
// unsigned integers.
//
// What bounds them: device memory. A pass moves every column four times
// (K2 reads and writes it, K3 reads and writes it): 16 B per element per
// int32 column. K3's stores are contiguous only within a run, so with
// 8-bit digits (about 16 elements per run of a 4096-element block) they
// land in partial 32-byte sectors.
//
// Design, not the TPU's: the TPU kernel sorted 1K tiles with a one-hot
// permutation matmul on the MXU, prefix sums by lane/sublane rolls, and
// merged tile runs with a sequential 512-step loop, because its vector
// unit has no per-lane variable shift; K3 moved runs by aligned DMA
// windows with QUANT tail padding. On Hopper each CTA ranks its elements
// directly: every warp walks its 512-element segment 32 at a time, groups
// equal digits with __match_any_sync, and keeps a running per-warp count
// per digit in shared memory, so an element's rank among equal digits
// before it in the block is (earlier warps' counts) + (running count) +
// (lower lanes with the same digit). That is stable by construction. A
// block scan of the digit counts gives the digit starts; each column is
// then scattered into shared memory at its rank and written out
// coalesced. K3 needs no padding: every thread stores its own element.

#include <cstdint>

#include <cuda_runtime.h>

#include "radix_common.cuh"

using namespace sa_radix;

namespace {

constexpr int kItems = 16;                    // elements per thread
constexpr int kBlock = kThreads * kItems;     // 4096 elements per CTA

__global__ void __launch_bounds__(kThreads)
block_digit_sort_kernel(Cols cols, int n_cols, int key_col, long long n,
                        int shift, int rbits, int32_t* __restrict__ hist) {
  // s_count: per-warp digit counts, then each warp's exclusive offset.
  __shared__ int s_count[kWarps][kMaxRadix];
  __shared__ int s_start[kMaxRadix];          // block-local digit starts
  __shared__ int32_t s_buf[kBlock];

  const int radix = 1 << rbits;
  const unsigned mask = static_cast<unsigned>(radix - 1);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  const int count =
      static_cast<int>(min(static_cast<long long>(kBlock), n - base));
  const int seg = warp * (kItems * 32);
  const unsigned lower = (1u << lane) - 1u;

  for (int i = tid; i < kWarps * kMaxRadix; i += kThreads) {
    (&s_count[0][0])[i] = 0;
  }
  __syncthreads();

  const int32_t* keys = cols.src[key_col];
  int32_t kv[kItems];
  int dig[kItems];
  int rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = seg + k * 32 + lane;
    const bool ok = j < count;
    kv[k] = ok ? keys[base + j] : 0;
    const int d = ok ? digit_of(kv[k], shift, mask) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = __popc(peers & lower);
    const int run = ok ? s_count[warp][d] : 0;
    __syncwarp();
    if (ok && before == 0) s_count[warp][d] = run + __popc(peers);
    __syncwarp();
    dig[k] = d;
    rank[k] = run + before;
  }
  __syncthreads();

  for (int d = tid; d < radix; d += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w][d];
      s_count[w][d] = run;
      run += c;
    }
    s_start[d] = run;
    hist[static_cast<long long>(blockIdx.x) * radix + d] = run;
  }
  __syncthreads();

  // Exclusive scan of the block's digit counts in warp 0.
  if (warp == 0) warp_exclusive_scan(s_start, radix, lane);
  __syncthreads();

  int dest[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int d = dig[k];
    dest[k] = d >= 0 ? s_start[d] + s_count[warp][d] + rank[k] : -1;
  }

  for (int c = 0; c < n_cols; ++c) {
    const int32_t* src = cols.src[c];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (dest[k] >= 0) {
        s_buf[dest[k]] =
            c == key_col ? kv[k] : src[base + seg + k * 32 + lane];
      }
    }
    __syncthreads();
    int32_t* dst = cols.dst[c];
    for (int j = tid; j < count; j += kThreads) dst[base + j] = s_buf[j];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
place_runs_kernel(Cols cols, int n_cols, int key_col, long long n, int shift,
                  int rbits, const int32_t* __restrict__ run_dst,
                  const int32_t* __restrict__ run_src) {
  __shared__ long long s_delta[kMaxRadix];    // run_dst - run_src per digit
  const int radix = 1 << rbits;
  const unsigned mask = static_cast<unsigned>(radix - 1);
  const long long row = static_cast<long long>(blockIdx.x) * radix;
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  const int count =
      static_cast<int>(min(static_cast<long long>(kBlock), n - base));
  for (int d = threadIdx.x; d < radix; d += kThreads) {
    s_delta[d] = static_cast<long long>(run_dst[row + d]) - run_src[row + d];
  }
  __syncthreads();

  const int32_t* keys = cols.src[key_col];
  for (int j = threadIdx.x; j < count; j += kThreads) {
    const long long p = base + j;
    const int32_t key = keys[p];
    const long long to = s_delta[digit_of(key, shift, mask)] + j;
    for (int c = 0; c < n_cols; ++c) {
      cols.dst[c][to] = c == key_col ? key : cols.src[c][p];
    }
  }
}

}  // namespace

extern "C" int sa_radix_block_elems() { return kBlock; }

// Columns s0..s{n_cols-1} -> staging d0..d{n_cols-1}, int32[n] each;
// hist int32[ceil(n / kBlock), 1 << rbits]. 1 <= n_cols <= 4,
// 0 <= key_col < n_cols, 1 <= rbits <= 8, 0 <= shift < 32. Unused
// pointers may be null. Returns the cudaGetLastError() code of the launch.
extern "C" int sa_block_digit_sort(const void* s0, const void* s1,
                                   const void* s2, const void* s3, void* d0,
                                   void* d1, void* d2, void* d3, int n_cols,
                                   int key_col, long long n, int shift,
                                   int rbits, void* hist, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kBlock - 1) / kBlock;
  block_digit_sort_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      make_cols(s0, s1, s2, s3, d0, d1, d2, d3), n_cols, key_col, n, shift,
      rbits, static_cast<int32_t*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// Staging s0.. (K2's output) -> d0.., int32[n] each; run_dst and run_src
// int32[ceil(n / kBlock), 1 << rbits] (kernels/radix.py::run_offsets).
// Same argument ranges as sa_block_digit_sort.
extern "C" int sa_place_runs(const void* s0, const void* s1, const void* s2,
                             const void* s3, void* d0, void* d1, void* d2,
                             void* d3, int n_cols, int key_col, long long n,
                             int shift, int rbits, const void* run_dst,
                             const void* run_src, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kBlock - 1) / kBlock;
  place_runs_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      make_cols(s0, s1, s2, s3, d0, d1, d2, d3), n_cols, key_col, n, shift,
      rbits, static_cast<const int32_t*>(run_dst),
      static_cast<const int32_t*>(run_src));
  return static_cast<int>(cudaGetLastError());
}
