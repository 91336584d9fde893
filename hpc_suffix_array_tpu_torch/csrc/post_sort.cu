// The pass after a carried-keys sort, on Hopper (sm_90a): tie flags,
// the chain statistics and the LCP of adjacent keys in one read of the
// sorted columns. It replaces no TPU kernel: the JAX package computes
// the same function in XLA (core/bigsort.py::_bucket_sort and
// _direct_sort3), and the port first ran it as about 100 PyTorch
// elementwise launches a call (kernels/post_sort.py::
// post_sort_reference, which stays as its oracle and CPU path).
//
// For m sorted rows of n_words (2 or 3) int32 key words and the int32
// positions idx, row j against row j - 1 (row -1: the caller's `prev`
// words, or the -1 sentinel without them):
//
//   tie[j]   = j > 0 and every key word equal;
//   delta[j] = idx[j] - idx[j-1] (negated in chain mode, `desc`);
//   stats    = (tie count, max(0, max delta over tied rows),
//               delta_ok = no tie or (min(2^30, min tied delta) == dmax
//               and dmax >= 1)), int64[3];
//   lcp[j]   = the first differing symbol: word by word, the highest
//              set bit of the first nonzero xor, clamped to 0; nw * spw
//              where all words agree; n - idx[j-1] on tied rows in chain
//              mode.
//
// What bounds it: device memory. A call reads 4 * (n_words + 1) bytes a
// row and writes 1 (tie) + 4 (lcp) bytes: at 2^30 rows of 2 words,
// 18.3 GB, 5.5 ms at 3.35 TB/s.
//
// Design:
//  * a persistent grid (the blocks that fit on the card at once), each
//    warp walking over 32 consecutive chunks of 4 rows at a time;
//  * a chunk's columns come in as one 16-byte load each, and its tie
//    flags and LCPs go out as one 4-byte and one 16-byte store. Rows
//    are counted from a `lead` that puts every chunk on a 16-byte
//    boundary, so a bucket's slice of the MSD slabs at any row offset
//    takes the wide path (where the columns' misalignments differ, the
//    VEC = false form loads every chunk row by row); only the chunks at
//    the two ends go row by row;
//  * row j - 1 of a chunk's first row comes from the lane before by a
//    shuffle, and lane 0 reads it again from memory (a cache hit: the
//    warp before loaded it). No intermediate goes to device memory;
//  * the statistics are reduced in registers and warp shuffles, one
//    partial a block, and one small launch (post_sort_stats_kernel)
//    folds the partials into the int64[3] stats: no atomics, so no
//    scratch to initialise and the same order every run.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                   // rows a chunk: one int4 a column
constexpr int kBig = 1 << 30;              // dmin where nothing ties
constexpr unsigned kFull = 0xffffffffu;

struct Partial {
  unsigned long long ties;
  int dmax;
  int dmin;
};

struct Args {
  const int32_t* word[3];
  const int32_t* idx;
  const int32_t* prev[3];                  // all null: the -1 sentinel
  uint8_t* tie;
  int32_t* lcp;                            // null: no LCP
  Partial* partial;
  long long m;
  long long n_chunks;
  int lead;                                // rows before row 0 in chunk 0
  int n;
  int spw;
  int bits;
  int desc;
};

__device__ __forceinline__ void fold(unsigned long long& ties, int& dmax,
                                     int& dmin, unsigned long long t, int hi,
                                     int lo) {
  ties += t;
  dmax = max(dmax, hi);
  dmin = min(dmin, lo);
}

// Sum, max and min over the warp, then over the block's warps; the
// result is valid in thread 0.
__device__ __forceinline__ void block_reduce(unsigned long long& ties,
                                             int& dmax, int& dmin) {
  __shared__ Partial s[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    fold(ties, dmax, dmin, __shfl_xor_sync(kFull, ties, off),
         __shfl_xor_sync(kFull, dmax, off), __shfl_xor_sync(kFull, dmin, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) s[warp] = Partial{ties, dmax, dmin};
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) fold(ties, dmax, dmin, s[w].ties,
                                          s[w].dmax, s[w].dmin);
  }
}

template <int NW, bool VEC>
__global__ void __launch_bounds__(kThreads)
post_sort_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const bool want_lcp = a.lcp != nullptr;
  unsigned long long ties = 0;
  int dmax = 0, dmin = kBig;
  // c0 is the same in every lane, so the whole warp takes each shuffle.
  for (long long c0 = static_cast<long long>(blockIdx.x) * kThreads +
                      (threadIdx.x & ~31);
       c0 < a.n_chunks; c0 += stride) {
    const long long j0 = (c0 + lane) * kRows - a.lead;   // row of slot 0
    const bool full = VEC && j0 >= 0 && j0 + kRows <= a.m;
    int32_t v[NW][kRows], ix[kRows];
    if (full) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const int4 q = *reinterpret_cast<const int4*>(a.word[w] + j0);
        v[w][0] = q.x; v[w][1] = q.y; v[w][2] = q.z; v[w][3] = q.w;
      }
      const int4 q = *reinterpret_cast<const int4*>(a.idx + j0);
      ix[0] = q.x; ix[1] = q.y; ix[2] = q.z; ix[3] = q.w;
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long j = j0 + r;
        const bool in = j >= 0 && j < a.m;
#pragma unroll
        for (int w = 0; w < NW; ++w) v[w][r] = in ? a.word[w][j] : 0;
        ix[r] = in ? a.idx[j] : 0;
      }
    }
    // Row j0 - 1: the previous lane's last row; lane 0 reads it.
    int32_t hv[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      hv[w] = __shfl_up_sync(kFull, v[w][kRows - 1], 1);
    }
    int32_t hi = __shfl_up_sync(kFull, ix[kRows - 1], 1);
    if (lane == 0 && j0 >= 1 && j0 <= a.m) {
#pragma unroll
      for (int w = 0; w < NW; ++w) hv[w] = a.word[w][j0 - 1];
      hi = a.idx[j0 - 1];
    }

    uint32_t flags = 0;
    int32_t out[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long j = j0 + r;
      int32_t x[NW];
      int32_t pi = r == 0 ? hi : ix[r - 1];
      bool eq = true;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        int32_t p = r == 0 ? hv[w] : v[w][r - 1];
        if (j == 0) p = a.prev[0] != nullptr ? *a.prev[w] : -1;
        x[w] = p ^ v[w][r];
        eq = eq && x[w] == 0;
      }
      if (j == 0) pi = ix[r];
      const bool tie = j > 0 && j < a.m && eq;
      if (tie) {
        const int d = a.desc ? pi - ix[r] : ix[r] - pi;
        fold(ties, dmax, dmin, 1, d, d);
      }
      flags |= static_cast<uint32_t>(tie) << (8 * r);
      if (want_lcp) {
        int l = NW * a.spw;
#pragma unroll
        for (int w = NW - 1; w >= 0; --w) {
          if (x[w] != 0) {
            l = (w + 1) * a.spw - 1 - (31 - __clz(x[w])) / a.bits;
          }
        }
        l = max(l, 0);
        out[r] = a.desc && tie ? a.n - pi : l;
      }
    }

    if (full) {
      *reinterpret_cast<uint32_t*>(a.tie + j0) = flags;
      if (want_lcp) {
        *reinterpret_cast<int4*>(a.lcp + j0) =
            make_int4(out[0], out[1], out[2], out[3]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long j = j0 + r;
        if (j >= 0 && j < a.m) {
          a.tie[j] = static_cast<uint8_t>((flags >> (8 * r)) & 1u);
          if (want_lcp) a.lcp[j] = out[r];
        }
      }
    }
  }
  block_reduce(ties, dmax, dmin);
  if (threadIdx.x == 0) a.partial[blockIdx.x] = Partial{ties, dmax, dmin};
}

// One block: the blocks' partials into stats int64[3].
__global__ void __launch_bounds__(kThreads)
post_sort_stats_kernel(const Partial* __restrict__ partial, int blocks,
                       long long* __restrict__ stats) {
  unsigned long long ties = 0;
  int dmax = 0, dmin = kBig;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    fold(ties, dmax, dmin, partial[b].ties, partial[b].dmax, partial[b].dmin);
  }
  block_reduce(ties, dmax, dmin);
  if (threadIdx.x == 0) {
    stats[0] = static_cast<long long>(ties);
    stats[1] = dmax;
    stats[2] = ties == 0 || (dmin == dmax && dmax >= 1);
  }
}

template <int NW, bool VEC>
cudaError_t launch(const Args& a, int cap, long long* stats,
                   cudaStream_t stream) {
  auto kernel = post_sort_kernel<NW, VEC>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const long long want = (a.n_chunks + kThreads - 1) / kThreads;
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > want) blocks = want;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  post_sort_stats_kernel<<<1, kThreads, 0, stream>>>(
      a.partial, static_cast<int>(blocks), stats);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_nw(int n_words, const Args& a, int cap, long long* stats,
                      cudaStream_t stream) {
  switch (n_words) {
    case 2: return launch<2, VEC>(a, cap, stats, stream);
    case 3: return launch<3, VEC>(a, cap, stats, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Partials the scratch must hold: at most this many blocks run.
extern "C" int sa_post_sort_max_blocks() { return 2048; }

// words[w] and idx int32[m] (m >= 1), prev[w] one int32 each or all
// null, tie uint8[m], lcp int32[m] or null (no LCP), scratch of
// `cap` partials (16 bytes each), stats int64[3]; all on the current
// device, launched on `stream`. n_words is 2 or 3, bits * spw <= 30.
// Returns the cudaGetLastError() code of the launches (0 on success).
extern "C" int sa_post_sort(const void* w0, const void* w1, const void* w2,
                            const void* idx, const void* p0, const void* p1,
                            const void* p2, void* tie, void* lcp,
                            void* scratch, int cap, void* stats, long long m,
                            int n_words, int n, int spw, int bits, int desc,
                            void* stream) {
  if (m <= 0 || n_words < 2 || n_words > 3 || cap < 1 || bits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  const void* words[3] = {w0, w1, w2};
  const void* prev[3] = {p0, p1, p2};
  for (int w = 0; w < 3; ++w) {
    a.word[w] = static_cast<const int32_t*>(words[w]);
    a.prev[w] = static_cast<const int32_t*>(prev[w]);
  }
  a.idx = static_cast<const int32_t*>(idx);
  a.tie = static_cast<uint8_t*>(tie);
  a.lcp = static_cast<int32_t*>(lcp);
  a.partial = static_cast<Partial*>(scratch);
  a.m = m;
  a.n = n;
  a.spw = spw;
  a.bits = bits;
  a.desc = desc;
  // The wide path needs one misalignment, in rows, for every int32
  // column (words, idx, lcp) and the same for the tie flags.
  const int lead = static_cast<int>(
      (reinterpret_cast<uintptr_t>(idx) & 15) >> 2);
  bool vec = true;
  for (int w = 0; w < n_words; ++w) {
    vec = vec && (reinterpret_cast<uintptr_t>(words[w]) & 15) ==
                     (reinterpret_cast<uintptr_t>(idx) & 15);
  }
  if (lcp != nullptr) {
    vec = vec && (reinterpret_cast<uintptr_t>(lcp) & 15) ==
                     (reinterpret_cast<uintptr_t>(idx) & 15);
  }
  vec = vec && ((reinterpret_cast<uintptr_t>(tie) - lead) & 3) == 0;
  a.lead = vec ? lead : 0;
  a.n_chunks = (m + a.lead + kRows - 1) / kRows;
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<long long*>(stats);
  const cudaError_t err = vec ? launch_nw<true>(n_words, a, cap, out, s)
                              : launch_nw<false>(n_words, a, cap, out, s);
  return static_cast<int>(err);
}
