// Pieces shared by the radix kernels: K2/K3 (csrc/radix.cu) and the
// onesweep sort (csrc/onesweep.cu).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace sa_radix {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRadix = 256;                // rbits <= 8
constexpr int kMaxCols = 4;                   // up to 3 key words + payload

struct Cols {
  const int32_t* src[kMaxCols];
  int32_t* dst[kMaxCols];
};

__device__ __forceinline__ int digit_of(int32_t key, int shift,
                                        unsigned mask) {
  return static_cast<int>((static_cast<uint32_t>(key) >> shift) & mask);
}

// Exclusive scan of counts[0, radix) in place, run by one whole warp:
// each lane sums a run of ceil(radix/32) entries, a shuffle scan offsets
// the runs.
__device__ __forceinline__ void warp_exclusive_scan(int* counts, int radix,
                                                    int lane) {
  const int per = (radix + 31) / 32;
  const int lo = min(lane * per, radix);
  const int hi = min(lo + per, radix);
  int sum = 0;
  for (int d = lo; d < hi; ++d) sum += counts[d];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  int run = incl - sum;
  for (int d = lo; d < hi; ++d) {
    const int c = counts[d];
    counts[d] = run;
    run += c;
  }
}

inline Cols make_cols(const void* s0, const void* s1, const void* s2,
                      const void* s3, void* d0, void* d1, void* d2,
                      void* d3) {
  Cols cols;
  const void* src[kMaxCols] = {s0, s1, s2, s3};
  void* dst[kMaxCols] = {d0, d1, d2, d3};
  for (int c = 0; c < kMaxCols; ++c) {
    cols.src[c] = static_cast<const int32_t*>(src[c]);
    cols.dst[c] = static_cast<int32_t*>(dst[c]);
  }
  return cols;
}

}  // namespace sa_radix
