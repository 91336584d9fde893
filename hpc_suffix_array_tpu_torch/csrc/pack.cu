// Packed initial ranks for prefix doubling: the Hopper (sm_90a) port of
// the TPU kernel hpc_suffix_array_tpu/kernels/pack.py::pack_ranks_pallas,
// fused with the remap gather and tail mask that the JAX package runs
// around it (core/suffix_array.py::pack_ranks_kernel):
//
//   out[i] = sum_{j<h0} code(i+offset+j) << bits*(h0-1-j)
//   code(p) = remap[text[p]] if p < n_real else 0
//
// offset 0 is the doubling builder's initial rank; offset w*spw is key
// word w of the carried-keys builder (core/bigsort.py::_direct_keys in
// the JAX package, where XLA ran the same fold at a word offset).
//
// What bounds it: device memory. Per position it reads one text byte
// (plus a 32-byte halo per 4096-position tile) and writes one int32,
// about 5 B of traffic; the plain PyTorch fold materialises int32 codes
// and re-reads a shifted copy per step, about h0 x 8 B per position.
//
// Design: one block per tile of kTile positions. The 256-entry remap and
// the tile's codes, plus a halo of the h0-1 <= 29 positions after the
// tile, are staged in shared memory, so each text byte leaves device
// memory once (as 4-byte vector loads where the tile is aligned and
// fully real). The word offset moves the tile's read window (text from
// base+offset) instead of widening the halo, so word 2 of a 1-bit
// alphabet (89 positions past i) needs no more shared memory. Each thread then folds kTile/kThreads outputs,
// consecutive threads on consecutive words, so every warp store is one
// coalesced 128-byte line. This is not the TPU kernel's lane/sublane
// roll scheme: on Hopper the shifted reads are plain shared-memory reads.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;
constexpr int kHalo = 32;   // >= h0 - 1 for every h0 <= 30

__global__ void __launch_bounds__(kThreads)
pack_ranks_kernel(const uint8_t* __restrict__ text,
                  const int32_t* __restrict__ remap,
                  int32_t* __restrict__ out, long long n, long long n_real,
                  long long offset, int bits, int h0) {
  __shared__ int32_t s_remap[256];
  __shared__ __align__(16) int32_t s_codes[kTile + kHalo];
  const int tid = threadIdx.x;
  s_remap[tid] = remap[tid];   // kThreads == 256
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long src = base + offset;   // text position of s_codes[0]
  int first_scalar = 0;
  if (src + kTile <= n_real &&
      (reinterpret_cast<uintptr_t>(text + src) & 3) == 0) {
    const uchar4* t4 = reinterpret_cast<const uchar4*>(text + src);
    int4* c4 = reinterpret_cast<int4*>(s_codes);
    for (int q = tid; q < kTile / 4; q += kThreads) {
      const uchar4 v = t4[q];
      c4[q] = make_int4(s_remap[v.x], s_remap[v.y], s_remap[v.z],
                        s_remap[v.w]);
    }
    first_scalar = kTile;
  }
  for (int i = first_scalar + tid; i < kTile + kHalo; i += kThreads) {
    const long long p = src + i;
    s_codes[i] = p < n_real ? s_remap[text[p]] : 0;
  }
  __syncthreads();

  for (int i = tid; i < kTile; i += kThreads) {
    const long long p = base + i;
    if (p >= n) break;
    // Unsigned fold: wraps exactly as torch's int32 shifts do.
    uint32_t acc = 0;
    for (int j = 0; j < h0; ++j) {
      acc = (acc << bits) | static_cast<uint32_t>(s_codes[i + j]);
    }
    out[p] = static_cast<int32_t>(acc);
  }
}

}  // namespace

// text uint8[n], remap int32[256], out int32[n], all on the current
// device; 0 <= n_real <= n, offset >= 0; launched on `stream`. Returns
// the cudaGetLastError() code of the launch (0 on success).
extern "C" int sa_pack_ranks(const void* text, const void* remap, void* out,
                             long long n, long long n_real, long long offset,
                             int bits, int h0, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kTile - 1) / kTile;
  pack_ranks_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const int32_t*>(remap),
      static_cast<int32_t*>(out), n, n_real, offset, bits, h0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
