// Packed key words: the Hopper (sm_90a) port of the TPU kernel
// hpc_suffix_array_tpu/kernels/pack.py::pack_ranks_pallas
// (_pack_block_kernel, :51; pallas_call, :66), fused with the remap
// gather and tail mask that the JAX package runs around it
// (core/suffix_array.py::pack_ranks_kernel) and widened to the key words
// of the carried-keys builders (core/bigsort.py::_dev_pack_word):
//
//   word w of row i = sum_{j<spw} code(i+offset+w*spw+j) << bits*(spw-1-j)
//   code(p) = table[text[p]] if p < n_real else 0
//
// for rows i < n_out and words w < n_words (1..3), in one launch that
// reads the text once. Every code is below 2^bits and bits*spw <= 30
// (the wrapper's precondition), so a rolling fold
//   acc = ((acc << bits) | code) & (2^(bits*spw) - 1)
// gives each row's word from the previous row's in one step.
//
// What bounds it: device memory. A launch reads the n_out + halo text
// bytes once and writes 4 * n_words bytes per row: at 2^28 rows, 1.34 GB
// for one word (0.401 ms at 3.35 TB/s), 2.42 GB for two.
//
// Design:
//  * one block per tile of kTile rows; the block stages its text window
//    [src, src + kTile + halo) (src = tile start + offset, halo =
//    n_words*spw - 1 <= 89) into shared memory as uint16 codes, read
//    with 16-byte loads from src rounded down to 16 bytes, so a word
//    offset, a chunk start or a text view at any address takes the wide
//    path; only vectors that straddle the text's real end or start go
//    byte by byte;
//  * each thread owns kRun consecutive rows: it warms up on spw - 1
//    codes, then takes one shared read and one shift-or per row and
//    word (the old kernel took spw reads per output);
//  * the codes are laid out with 2 halfwords of padding per 16 codes,
//    so thread t's run starts at word 9t (9 is odd): the fold's reads
//    and the staging's writes are free of bank conflicts;
//  * stores are staged through shared memory (32 KB a block): each
//    thread puts its run there as 16-byte chunks, rotated so that no
//    two threads of a quarter-warp share a bank group, then the block
//    writes the tile in row order, consecutive threads on consecutive
//    16-byte chunks, so every warp store covers 512 contiguous bytes.
//    (Stores straight from each thread's run, 64 bytes apart, ran at
//    1.3-1.6 TB/s on an H100 and 0.9 TB/s into pk2's columns.) Into the
//    columns of a row-major (rows, 2) table a chunk holds two rows' word
//    pairs; any other strided layout takes one 4-byte store per word.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                    // rows per thread
constexpr int kTile = kThreads * kRun;      // rows per block
constexpr int kHaloMax = 3 * 30 - 1;        // n_words * spw - 1, at most
constexpr int kWindowMax = kTile + kHaloMax;

// Shared index of window code k: 18 halfwords per 16 codes.
__device__ __forceinline__ int slot(int k) { return k + ((k >> 4) << 1); }

constexpr int kSlots = kWindowMax + ((kWindowMax >> 4) << 1) + 2;

enum Store : int { kScalar = 0, kVector = 1, kPairs = 2 };

// The words of rows [first, first + kRun) of the window: warm up on
// spw - 1 codes, then one shared read and one shift-or per row.
__device__ __forceinline__ void fold_run(const uint16_t* s_codes, int k,
                                         int spw, int bits, uint32_t mask,
                                         int32_t (&v)[kRun]) {
  uint32_t acc = 0;
  for (int j = 0; j < spw - 1; ++j) {
    acc = (acc << bits) | s_codes[slot(k + j)];
  }
  k += spw - 1;
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    acc = ((acc << bits) | s_codes[slot(k + r)]) & mask;
    v[r] = static_cast<int32_t>(acc);
  }
}

// int4 slot of thread t's chunk j (C chunks a thread) in the output
// staging buffer, rotated so that the 8 threads of a quarter-warp hit 8
// distinct 16-byte bank groups both when a thread stores its own C
// chunks and when consecutive chunks are read back in row order.
template <int C>
__device__ __forceinline__ int chunk_slot(int t, int j) {
  return C * t + ((j + ((t * C) >> 3)) & (C - 1));
}

// Write the block's staged chunks (C a thread, RPC rows each) to out in
// row order, consecutive threads on consecutive 16-byte chunks. Rows at
// or past n_out are not written.
template <int C, int RPC>
__device__ __forceinline__ void write_chunks(const int4* staged,
                                             int32_t* out, long long base,
                                             long long n_out, int tid) {
  constexpr int kInts = 4 / RPC;           // int32 values a row takes
  int32_t* tile = out + base * kInts;
  for (int q = tid; q < kThreads * C; q += kThreads) {
    const int4 c = staged[chunk_slot<C>(q / C, q % C)];
    const long long row = base + static_cast<long long>(q) * RPC;
    if (row + RPC <= n_out) {
      reinterpret_cast<int4*>(tile)[q] = c;
    } else {
      const int32_t e[4] = {c.x, c.y, c.z, c.w};
      for (int i = 0; i < 4; ++i) {
        if (row + i / kInts < n_out) tile[4 * q + i] = e[i];
      }
    }
  }
}

template <int NW, int MODE>
__global__ void __launch_bounds__(kThreads)
pack_words_kernel(const uint8_t* __restrict__ text,
                  const int32_t* __restrict__ table,
                  int32_t* __restrict__ out0, int32_t* __restrict__ out1,
                  int32_t* __restrict__ out2, long long stride,
                  long long n_out, long long n_real, long long offset,
                  int bits, int spw) {
  __shared__ uint32_t s_tab[256];
  __shared__ uint16_t s_codes[kSlots];
  __shared__ int4 s_out[kThreads * 8];
  const int tid = threadIdx.x;
  s_tab[tid] = static_cast<uint32_t>(table[tid]);   // kThreads == 256
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long src = base + offset;     // text position of code 0
  const int window = kTile + NW * spw - 1;
  const int lead = static_cast<int>(
      reinterpret_cast<uintptr_t>(text + src) & 15);
  const uint8_t* aligned = text + src - lead;
  const int n_vec = (lead + window + 15) >> 4;
  for (int v = tid; v < n_vec; v += kThreads) {
    const int k0 = (v << 4) - lead;        // window index of byte 0
    const long long p0 = src + k0;         // its text position
    if (p0 >= 0 && p0 + 16 <= n_real) {
      const uint4 q = *reinterpret_cast<const uint4*>(aligned + (v << 4));
      const uint32_t w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int k = k0 + b;
        if (k >= 0 && k < window) {
          s_codes[slot(k)] = static_cast<uint16_t>(
              s_tab[(w4[b >> 2] >> ((b & 3) * 8)) & 0xFF]);
        }
      }
    } else {
      for (int b = 0; b < 16; ++b) {
        const int k = k0 + b;
        if (k >= 0 && k < window) {
          const long long p = p0 + b;
          s_codes[slot(k)] = p < n_real
              ? static_cast<uint16_t>(s_tab[text[p]]) : uint16_t{0};
        }
      }
    }
  }
  __syncthreads();

  const uint32_t mask = (1u << (bits * spw)) - 1u;
  const int first = tid * kRun;            // window index of row 0's code 0
  int32_t* const outs[3] = {out0, out1, out2};
  if (MODE == kVector) {
    // One word at a time, staged in alternating halves of s_out (one
    // barrier per word: a thread staging word w + 2 has passed the
    // barrier of word w + 1, so every thread has written word w out).
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      int32_t v[kRun];
      fold_run(s_codes, first + w * spw, spw, bits, mask, v);
      int4* half = s_out + (w & 1) * (kThreads * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        half[chunk_slot<4>(tid, j)] = make_int4(v[4 * j], v[4 * j + 1],
                                                v[4 * j + 2], v[4 * j + 3]);
      }
      __syncthreads();
      write_chunks<4, 4>(half, outs[w], base, n_out, tid);
    }
  } else if (MODE == kPairs && NW == 2) {
    int32_t v0[kRun], v1[kRun];
    fold_run(s_codes, first, spw, bits, mask, v0);
    fold_run(s_codes, first + spw, spw, bits, mask, v1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s_out[chunk_slot<8>(tid, j)] = make_int4(v0[2 * j], v1[2 * j],
                                               v0[2 * j + 1], v1[2 * j + 1]);
    }
    __syncthreads();
    write_chunks<8, 2>(s_out, out0, base, n_out, tid);
  } else {
    const long long row0 = base + first;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      int32_t v[kRun];
      fold_run(s_codes, first + w * spw, spw, bits, mask, v);
      int32_t* out = outs[w];
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (row0 + r < n_out) out[(row0 + r) * stride] = v[r];
      }
    }
  }
}

template <int NW>
void launch(int mode, unsigned blocks, cudaStream_t stream,
            const uint8_t* text, const int32_t* table, int32_t* const* out,
            long long stride, long long n_out, long long n_real,
            long long offset, int bits, int spw) {
  auto kernel = mode == kVector ? pack_words_kernel<NW, kVector>
              : mode == kPairs  ? pack_words_kernel<NW, kPairs>
                                : pack_words_kernel<NW, kScalar>;
  kernel<<<blocks, kThreads, 0, stream>>>(text, table, out[0], out[1],
                                          out[2], stride, n_out, n_real,
                                          offset, bits, spw);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// text uint8[>= n_real], table int32[256] (codes below 2^bits), out[w]
// int32 with element stride `stride` for w < n_words, all on the current
// device; 1 <= n_words <= 3, bits*spw <= 30, n_out, n_real, offset >= 0;
// launched on `stream`. Returns the cudaGetLastError() code of the
// launch (0 on success).
extern "C" int sa_pack_words(const void* text, const void* table,
                             void* out0, void* out1, void* out2,
                             long long stride, long long n_out,
                             long long n_real, long long offset, int bits,
                             int spw, int n_words, void* stream) {
  if (n_out <= 0) return 0;
  int32_t* out[3] = {static_cast<int32_t*>(out0),
                     static_cast<int32_t*>(out1),
                     static_cast<int32_t*>(out2)};
  int mode = kScalar;
  if (stride == 1) {
    bool ok = true;
    for (int w = 0; w < n_words; ++w) ok = ok && aligned16(out[w]);
    if (ok) mode = kVector;
  } else if (stride == 2 && n_words == 2 && out[1] == out[0] + 1 &&
             aligned16(out[0])) {
    mode = kPairs;
  }
  const unsigned blocks = static_cast<unsigned>((n_out + kTile - 1) / kTile);
  const auto* t = static_cast<const uint8_t*>(text);
  const auto* tab = static_cast<const int32_t*>(table);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 1: launch<1>(mode, blocks, s, t, tab, out, stride, n_out, n_real,
                      offset, bits, spw); break;
    case 2: launch<2>(mode, blocks, s, t, tab, out, stride, n_out, n_real,
                      offset, bits, spw); break;
    case 3: launch<3>(mode, blocks, s, t, tab, out, stride, n_out, n_real,
                      offset, bits, spw); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
