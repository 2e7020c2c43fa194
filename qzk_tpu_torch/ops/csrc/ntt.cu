// Goldilocks NTT kernel for Hopper (sm_90a): K3, all radix-2 stages of
// a transform along the row axis.
//
// K3 qzk_ntt_axis0 replaces the Pallas kernel _ntt_axis0_pallas
// (qzk_tpu/ops/ntt_pallas.py, body _ntt_axis0_kernel).  For every
// column of a (B, 2^log_n, M) input it computes the length-2^log_n NTT
// (radix-2 DIT, natural order at both ends) and, when a twiddle block
// is given, multiplies the result elementwise by it: one pass of the
// four-step transform (ops/ntt_fourstep.py), which launches it twice
// per transform, for the long single vector and for the prover's
// batched rows alike.
//
// What bounds it on this card: device-memory bytes.  A pass reads its
// input once (and the twiddle block) and writes its output once; the
// log_n butterfly stages in between are a few dozen integer
// instructions per element each, well under the card's integer rate
// at 2^11 rows.  So a block holds its whole (2^log_n, C) column tile in
// shared memory for all stages, with one __syncthreads() per stage.
// The TPU kernel held 256 columns of 2048 rows in 128 MB of VMEM; a
// Hopper block has at most 227 KB, so the tile is C columns wide (the
// wrapper picks C, a power of two, for about 64 KB: C = 4 at 2048
// rows), in dynamic shared memory (opted in above 48 KB by
// qzk_ntt_init).  The bit-reversal of the rows is folded into the load
// and the twiddle product into the store, so each pass is one read
// and one write of the data.
//
// The input may be strided: the second four-step pass reads the
// transpose of the first pass's output in place (rows unit-stride),
// so no transposed copy is made.  The load walks whichever axis is
// unit-stride with consecutive threads, so reads coalesce either way.
// The tile gains one word of padding every 2^(log_n-4) rows: the
// bit-reversed rows of one half-warp's stores would otherwise fall into
// one shared-memory bank.  Grid: (ceil(M / C), B); the last column tile
// may be ragged.  Outputs are canonical for canonical inputs.
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;

struct Tile {
  uint64_t* s;
  int log_c;
  int pad_shift;
  __device__ __forceinline__ uint64_t& at(int r, int c) const {
    return s[(r << log_c) + c + (r >> pad_shift)];
  }
};

__global__ void __launch_bounds__(THREADS)
    ntt_axis0_kernel(const uint64_t* __restrict__ in, long long sb, long long sr,
                     long long sc, uint64_t* __restrict__ out,
                     const uint64_t* __restrict__ stw,
                     const uint64_t* __restrict__ twiddle, int log_n, long long m,
                     int log_c) {
  extern __shared__ uint64_t smem[];
  const Tile tile{smem, log_c, log_n > 4 ? log_n - 4 : 31};
  const int n = 1 << log_n;
  const int cw = 1 << log_c;
  const int total = n << log_c;
  const long long c0 = (long long)blockIdx.x << log_c;
  const int t = threadIdx.x;
  in += (long long)blockIdx.y * sb;
  out += (long long)blockIdx.y * n * m;

  // Load: source row `src` goes to tile row rev(src).
  const bool rows_fast = sc != 1;
  for (int k = t; k < total; k += THREADS) {
    int src, c;
    if (rows_fast) {
      src = k & (n - 1);
      c = k >> log_n;
    } else {
      src = k >> log_c;
      c = k & (cw - 1);
    }
    const long long col = c0 + c;
    const int r = log_n ? (int)(__brev((unsigned)src) >> (32 - log_n)) : 0;
    tile.at(r, c) = col < m ? in[src * sr + col * sc] : 0ull;
  }

  // Stages: butterfly i works on column i % C of pair i / C.
  const int tw_stride = n > 1 ? n >> 1 : 1;
  for (int s = 1; s <= log_n; ++s) {
    __syncthreads();
    const int h = s - 1;
    const uint64_t* tw = stw + (long long)h * tw_stride;
    for (int i = t; i < (total >> 1); i += THREADS) {
      const int p = i >> log_c;
      const int c = i & (cw - 1);
      const int j = p & ((1 << h) - 1);
      const int top = ((p >> h) << (h + 1)) | j;
      uint64_t& a = tile.at(top, c);
      uint64_t& b = tile.at(top + (1 << h), c);
      const uint64_t e = a;
      const uint64_t o = gl::mul(b, __ldg(tw + j));
      a = gl::add(e, o);
      b = gl::sub(e, o);
    }
  }
  __syncthreads();

  // Store, times the twiddle block when there is one.
  for (int k = t; k < total; k += THREADS) {
    const int r = k >> log_c;
    const int c = k & (cw - 1);
    const long long col = c0 + c;
    if (col < m) {
      uint64_t v = tile.at(r, c);
      if (twiddle != nullptr) v = gl::mul(v, __ldg(twiddle + r * m + col));
      out[r * m + col] = v;
    }
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of a (2^log_n, 2^log_c) tile, padding included.
long long qzk_ntt_tile_bytes(int log_n, int log_c) {
  return (((1ll << log_n) << log_c) + 16) * 8;
}

// Lets the kernel take up to the device's opt-in shared memory a block
// (227 KB on an H100) on the current device; returns that size in
// *max_bytes.  Call once per device before any launch.
int qzk_ntt_init(int* max_bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(ntt_axis0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *max_bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// in: (B, 2^log_n, M) at element strides (sb, sr, sc); out: (B, 2^log_n,
// M) contiguous; stw: (log_n, max(1, n/2)) stage twiddles; twiddle:
// (2^log_n, M) contiguous, or null.  All on the device.
int qzk_ntt_axis0(const uint64_t* in, long long sb, long long sr, long long sc,
                  uint64_t* out, const uint64_t* stw, const uint64_t* twiddle,
                  int log_n, long long m, long long b, int log_c, void* stream) {
  const dim3 grid((unsigned)((m + (1ll << log_c) - 1) >> log_c), (unsigned)b);
  const size_t smem = (size_t)qzk_ntt_tile_bytes(log_n, log_c);
  ntt_axis0_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      in, sb, sr, sc, out, stw, twiddle, log_n, m, log_c);
  return (int)cudaGetLastError();
}

}  // extern "C"
