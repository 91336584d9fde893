// The refinement's word round around its sort, on Hopper (sm_90a): the
// gather of each row's next two key words before the sort, and the split
// of the sorted rows into segments after it. It replaces no TPU kernel:
// the JAX package computes the same functions in XLA (core/refine.py::
// _refine_round), and the port first ran them as about 65 PyTorch
// launches a round (kernels/refine_round.py::round_gather_reference and
// round_split_reference, which stay as the oracle and the CPU path).
//
// round_gather: for m rows with text positions idx,
//
//   (w0[j], w1[j]) = pk2[min(idx[j] + d, n)],
//
// pk2 the int32[n + 1, 2] pair table (row n the all-pad pair). It reads
// 4 B of idx and one 8-byte pk2 row a row and writes 8 B: 20 B a row,
// 5.4 GB at 2^28 rows, 1.6 ms at 3.35 TB/s; the pk2 rows are random, so
// each costs a 32-byte sector in practice. Four rows a thread: idx in one
// 16-byte load, four independent 8-byte loads in flight, the words out in
// two 16-byte stores. No int64 index column is built.
//
// round_split: for m rows sorted by (seg, w0, w1), row j against row
// j - 1 (row -1: the -1 sentinel in every column),
//
//   parent[j] = seg[j] != seg[j-1];  x = w ^ w[j-1] word by word;
//   head[j]   = parent[j] or x != 0;
//   patch[j]  = d + the first differing symbol (highest set bit of the
//               first nonzero xor; symbols pack first-highest) where
//               head[j] and not parent[j], else kept;
//   seg[j]    = (heads at rows <= j) - 1, written over the input seg;
//   tied      = m - heads, int64.
//
// It reads seg, w0, w1 and patch and writes patch and seg: 24 B a row,
// 6.4 GB at 2^28 rows, 1.9 ms at 3.35 TB/s. Three launches:
//  * round_split_kernel: one block a tile of 4096 rows, each thread four
//    chunks of 4 rows; a chunk's columns come in as 16-byte loads, row
//    j - 1 of its first row from the lane before by a shuffle (lane 0
//    reads it again from memory, a cache hit). Rows are counted from a
//    `lead` that puts every chunk on a 16-byte boundary (post_sort.cu's
//    scheme); where the columns' misalignments differ, the VEC = false
//    form goes row by row. It writes the patch, one head bit a row (the
//    nibbles of 8 lanes folded into one word by shuffles: 1/8 B a row)
//    and the tile's head count;
//  * round_scan_kernel: one block turns the tiles' counts into exclusive
//    offsets and writes tied; no atomics, so the same result every run;
//  * round_ids_kernel: one block a tile reads its 128 head words, scans
//    their popcounts in shared memory and writes the ordinals over seg
//    with 16-byte stores. The first launch has read seg by then, so no
//    column is allocated.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;                       // rows a chunk
constexpr int kSteps = 4;                      // chunks a thread, a tile
constexpr int kTileChunks = kThreads * kSteps;
constexpr int kTileRows = kTileChunks * kRows;  // 4096
constexpr int kTileWords = kTileRows / 32;      // head bits of a tile
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// An int32 pointer's offset past a 16-byte boundary, in rows.
inline int lead_of(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

// Whether two pointers lie at the same offset past a 16-byte boundary.
inline bool same_phase(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) & 15) ==
         (reinterpret_cast<uintptr_t>(b) & 15);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
round_gather_kernel(const int32_t* __restrict__ idx,
                    const int2* __restrict__ pk2, int32_t* __restrict__ w0,
                    int32_t* __restrict__ w1, long long m, long long n_chunks,
                    int lead, long long d, long long n) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (c >= n_chunks) return;
  const long long j0 = c * kRows - lead;
  const bool full = VEC && j0 >= 0 && j0 + kRows <= m;
  int32_t ix[kRows];
  if (full) {
    const int4 q = *reinterpret_cast<const int4*>(idx + j0);
    ix[0] = q.x; ix[1] = q.y; ix[2] = q.z; ix[3] = q.w;
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long j = j0 + r;
      ix[r] = j >= 0 && j < m ? idx[j] : 0;
    }
  }
  int2 g[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long j = j0 + r;
    const long long k = min(static_cast<long long>(ix[r]) + d, n);
    g[r] = full || (j >= 0 && j < m) ? __ldg(pk2 + k) : make_int2(0, 0);
  }
  if (full) {
    *reinterpret_cast<int4*>(w0 + j0) = make_int4(g[0].x, g[1].x, g[2].x,
                                                  g[3].x);
    *reinterpret_cast<int4*>(w1 + j0) = make_int4(g[0].y, g[1].y, g[2].y,
                                                  g[3].y);
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long j = j0 + r;
      if (j >= 0 && j < m) {
        w0[j] = g[r].x;
        w1[j] = g[r].y;
      }
    }
  }
}

struct SplitArgs {
  int32_t* seg;
  const int32_t* w0;
  const int32_t* w1;
  int32_t* patch;
  uint32_t* heads;                             // one bit a slot, by tile
  int32_t* count;                              // heads a tile, then offsets
  long long* tied;
  long long m;
  long long tiles;
  int lead;                                    // slots before row 0
  int d;
  int spw;
  int bits;
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
round_split_kernel(const SplitArgs a) {
  const int lane = threadIdx.x & 31;
  const long long tile = blockIdx.x;
  int heads = 0;
#pragma unroll 1
  for (int k = 0; k < kSteps; ++k) {
    const long long c = tile * kTileChunks + k * kThreads + threadIdx.x;
    const long long j0 = c * kRows - a.lead;   // row of slot 0
    const bool full = VEC && j0 >= 0 && j0 + kRows <= a.m;
    int32_t sg[kRows], v0[kRows], v1[kRows], pt[kRows];
    if (full) {
      const int4 qs = *reinterpret_cast<const int4*>(a.seg + j0);
      const int4 q0 = *reinterpret_cast<const int4*>(a.w0 + j0);
      const int4 q1 = *reinterpret_cast<const int4*>(a.w1 + j0);
      const int4 qp = *reinterpret_cast<const int4*>(a.patch + j0);
      sg[0] = qs.x; sg[1] = qs.y; sg[2] = qs.z; sg[3] = qs.w;
      v0[0] = q0.x; v0[1] = q0.y; v0[2] = q0.z; v0[3] = q0.w;
      v1[0] = q1.x; v1[1] = q1.y; v1[2] = q1.z; v1[3] = q1.w;
      pt[0] = qp.x; pt[1] = qp.y; pt[2] = qp.z; pt[3] = qp.w;
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long j = j0 + r;
        const bool in = j >= 0 && j < a.m;
        sg[r] = in ? a.seg[j] : 0;
        v0[r] = in ? a.w0[j] : 0;
        v1[r] = in ? a.w1[j] : 0;
        pt[r] = in ? a.patch[j] : 0;
      }
    }
    // Row j0 - 1: the previous lane's last row; lane 0 reads it.
    int32_t hs = __shfl_up_sync(kFull, sg[kRows - 1], 1);
    int32_t h0 = __shfl_up_sync(kFull, v0[kRows - 1], 1);
    int32_t h1 = __shfl_up_sync(kFull, v1[kRows - 1], 1);
    if (lane == 0 && j0 >= 1 && j0 <= a.m) {
      hs = a.seg[j0 - 1];
      h0 = a.w0[j0 - 1];
      h1 = a.w1[j0 - 1];
    }

    uint32_t nib = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long j = j0 + r;
      int32_t ps = r == 0 ? hs : sg[r - 1];
      int32_t p0 = r == 0 ? h0 : v0[r - 1];
      int32_t p1 = r == 0 ? h1 : v1[r - 1];
      if (j == 0) ps = p0 = p1 = -1;
      const bool parent = sg[r] != ps;
      const int32_t x0 = v0[r] ^ p0;
      const int32_t x1 = v1[r] ^ p1;
      const bool in_w0 = x0 != 0;
      const bool wdiff = in_w0 || x1 != 0;
      if (j >= 0 && j < a.m && (parent || wdiff)) nib |= 1u << r;
      if (wdiff && !parent) {
        const int hb = 31 - __clz(in_w0 ? x0 : x1);
        const int last = in_w0 ? a.spw - 1 : 2 * a.spw - 1;
        pt[r] = a.d + last - hb / a.bits;
      }
    }

    if (full) {
      *reinterpret_cast<int4*>(a.patch + j0) =
          make_int4(pt[0], pt[1], pt[2], pt[3]);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long j = j0 + r;
        if (j >= 0 && j < a.m) a.patch[j] = pt[r];
      }
    }
    heads += __popc(nib);
    // Chunk c's slots are bits 4 (c % 8) .. + 3 of head word c / 8, and
    // the 8 lanes of a word hold consecutive chunks.
    uint32_t word = nib << (kRows * (lane & 7));
    word |= __shfl_xor_sync(kFull, word, 1);
    word |= __shfl_xor_sync(kFull, word, 2);
    word |= __shfl_xor_sync(kFull, word, 4);
    if ((lane & 7) == 0) a.heads[c >> 3] = word;
  }

  __shared__ int s_warp[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    heads += __shfl_xor_sync(kFull, heads, off);
  }
  if (lane == 0) s_warp[threadIdx.x >> 5] = heads;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += s_warp[w];
    a.count[tile] = sum;
  }
}

// Inclusive warp scan.
template <typename T>
__device__ __forceinline__ T warp_scan(T v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// One block: count[t] becomes the heads of tiles before t; tied = m -
// all heads.
__global__ void __launch_bounds__(kScanThreads)
round_scan_kernel(const SplitArgs a) {
  __shared__ long long s_warp[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long per = (a.tiles + kScanThreads - 1) / kScanThreads;
  const long long lo = min(a.tiles, tid * per);
  const long long hi = min(a.tiles, lo + per);
  long long sum = 0;
  for (long long t = lo; t < hi; ++t) sum += a.count[t];
  const long long incl = warp_scan(sum, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) s_warp[lane] = warp_scan(s_warp[lane], lane);
  __syncthreads();
  long long run = incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  for (long long t = lo; t < hi; ++t) {
    const int c = a.count[t];
    a.count[t] = static_cast<int32_t>(run);
    run += c;
  }
  if (tid == kScanThreads - 1) *a.tied = a.m - run;
}

// One block a tile: the ordinals from the head bits and the offsets.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
round_ids_kernel(const SplitArgs a) {
  __shared__ uint32_t s_word[kTileWords];
  __shared__ int s_pre[kTileWords];
  __shared__ int s_warp[kTileWords / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long tile = blockIdx.x;
  if (tid < kTileWords) {
    const uint32_t w = a.heads[tile * kTileWords + tid];
    const int p = __popc(w);
    const int incl = warp_scan(p, lane);
    s_word[tid] = w;
    s_pre[tid] = incl - p;
    if (lane == 31) s_warp[tid >> 5] = incl;
  }
  __syncthreads();
  const int base = a.count[tile];
#pragma unroll 1
  for (int k = 0; k < kSteps; ++k) {
    const int cl = k * kThreads + tid;         // chunk in the tile
    const long long j0 = (tile * kTileChunks + cl) * kRows - a.lead;
    const int wl = cl >> 3;
    const int b = kRows * (cl & 7);
    const uint32_t word = s_word[wl];
    int before = 0;
    for (int w = 0; w < (wl >> 5); ++w) before += s_warp[w];
    int cnt = base + before + s_pre[wl] + __popc(word & ((1u << b) - 1u));
    int32_t out[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      cnt += (word >> (b + r)) & 1u;
      out[r] = cnt - 1;
    }
    if (VEC && j0 >= 0 && j0 + kRows <= a.m) {
      *reinterpret_cast<int4*>(a.seg + j0) =
          make_int4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long j = j0 + r;
        if (j >= 0 && j < a.m) a.seg[j] = out[r];
      }
    }
  }
}

template <bool VEC>
cudaError_t launch_split(const SplitArgs& a, cudaStream_t stream) {
  const auto blocks = static_cast<unsigned>(a.tiles);
  round_split_kernel<VEC><<<blocks, kThreads, 0, stream>>>(a);
  round_scan_kernel<<<1, kScanThreads, 0, stream>>>(a);
  round_ids_kernel<VEC><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Rows of a split tile: the split's scratch holds kTileWords head words
// and one count a tile.
extern "C" int sa_round_tile_rows() { return kTileRows; }

// idx int32[m] (m >= 1), pk2 int32[n + 1, 2] (8-byte aligned), w0 and w1
// int32[m]; all on the current device, launched on `stream`. Returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int sa_round_gather(const void* idx, const void* pk2, void* w0,
                               void* w1, long long m, long long d,
                               long long n, void* stream) {
  if (m <= 0 || d < 0 || n < 0 ||
      (reinterpret_cast<uintptr_t>(pk2) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = same_phase(idx, w0) && same_phase(idx, w1);
  const int lead = vec ? lead_of(idx) : 0;
  const long long n_chunks = (m + lead + kRows - 1) / kRows;
  const auto blocks =
      static_cast<unsigned>((n_chunks + kThreads - 1) / kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* tab = static_cast<const int2*>(pk2);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* o0 = static_cast<int32_t*>(w0);
  auto* o1 = static_cast<int32_t*>(w1);
  if (vec) {
    round_gather_kernel<true><<<blocks, kThreads, 0, s>>>(
        ix, tab, o0, o1, m, n_chunks, lead, d, n);
  } else {
    round_gather_kernel<false><<<blocks, kThreads, 0, s>>>(
        ix, tab, o0, o1, m, n_chunks, lead, d, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// seg, w0, w1 and patch int32[m] (m >= 1), sorted by (seg, w0, w1);
// heads of cap_tiles * kTileWords uint32 and count of cap_tiles int32
// (scratch, no initial value), tied int64[1]; all on the current device,
// launched on `stream`. bits * spw <= 30. Writes the ordinals over seg.
// Returns the cudaGetLastError() code of the launches (0 on success).
extern "C" int sa_round_split(void* seg, const void* w0, const void* w1,
                              void* patch, void* heads, void* count,
                              long long cap_tiles, void* tied, long long m,
                              int d, int spw, int bits, void* stream) {
  if (m <= 0 || spw < 1 || bits < 1 || bits * spw > 30 || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = same_phase(seg, w0) && same_phase(seg, w1) &&
                   same_phase(seg, patch);
  SplitArgs a;
  a.seg = static_cast<int32_t*>(seg);
  a.w0 = static_cast<const int32_t*>(w0);
  a.w1 = static_cast<const int32_t*>(w1);
  a.patch = static_cast<int32_t*>(patch);
  a.heads = static_cast<uint32_t*>(heads);
  a.count = static_cast<int32_t*>(count);
  a.tied = static_cast<long long*>(tied);
  a.m = m;
  a.lead = vec ? lead_of(seg) : 0;
  a.tiles = (m + a.lead + kTileRows - 1) / kTileRows;
  a.d = d;
  a.spw = spw;
  a.bits = bits;
  if (a.tiles > cap_tiles) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec ? launch_split<true>(a, s)
                              : launch_split<false>(a, s));
}
