// Poseidon kernels for Hopper (sm_90a): the row sponge (K1) and the
// batched permutation (K2).
//
// K1 qzk_hash_rows replaces the Pallas kernel _hash_rows_pallas
// (qzk_tpu/ops/poseidon_pallas.py, body _make_hash_kernel).  It computes
// hash_no_pad of every row of an (n, w) matrix: overwrite-mode sponge,
// width 12, rate 8, all ceil(w/8) permutations chained while the 12-lane
// state stays in one thread's registers; the digest is the first 4 lanes.
// It builds every Merkle leaf and tree level of the prover.
//
// K2 qzk_permute replaces _permute_pallas (same file, body _kernel ->
// _permute_tiles): one Poseidon permutation per (12,) state.  The prover
// grinds its proof-of-work batches on it.
//
// What bounds them on this card: integer multiply throughput.  One
// permutation is 30 rounds; a full round takes 12 S-boxes of 4 modular
// products, a partial round 1, and every round an MDS layer of 144 small
// products on the two 32-bit halves of each lane.  Against that K1 reads
// only n*w*8 bytes (and writes n*32), so the kernel keeps the state in
// registers, reads each input word once and never writes the state out
// between absorptions.  Reads are coalesced: a block stages its rows'
// current 8-column chunk through shared memory with consecutive threads
// on consecutive addresses.  The round constants and the MDS matrix sit
// in __constant__ memory, where every thread of a warp reads the same
// word at once.  Speed is later work: the MDS products are plain 64-bit
// multiplies, not shifts and adds.
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int CAP = 4;
constexpr int HALF_FULL = 4;
constexpr int N_PARTIAL = 22;
constexpr int N_ROUNDS = 2 * HALF_FULL + N_PARTIAL;
constexpr int ROWS = 128;  // threads per block, one row or state each

__constant__ uint64_t c_rc[N_ROUNDS * WIDTH];
__constant__ uint64_t c_mds[WIDTH * WIDTH];

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  uint64_t x2 = gl::mul(x, x);
  uint64_t x3 = gl::mul(x2, x);
  uint64_t x4 = gl::mul(x2, x2);
  return gl::mul(x4, x3);
}

// out[r] = sum_c M[r][c] * s[c], summed exactly as 32-bit halves and
// reduced once per lane (ops/poseidon_torch.py mds_layer).
__device__ __forceinline__ void mds(uint64_t s[WIDTH]) {
  uint64_t out[WIDTH];
#pragma unroll
  for (int r = 0; r < WIDTH; ++r) {
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int c = 0; c < WIDTH; ++c) {
      const uint64_t m = c_mds[r * WIDTH + c];
      lo += m * (s[c] & 0xFFFFFFFFull);
      hi += m * (s[c] >> 32);
    }
    const uint64_t lo64 = lo + (hi << 32);
    const uint64_t hi64 = (hi >> 32) + (lo64 < lo ? 1ull : 0ull);
    out[r] = gl::reduce128(lo64, hi64);
  }
#pragma unroll
  for (int r = 0; r < WIDTH; ++r) s[r] = out[r];
}

__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox(gl::add(s[i], c_rc[r * WIDTH + i]));
  mds(s);
}

__device__ void permute(uint64_t s[WIDTH]) {
#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) full_round(s, r);
#pragma unroll 1
  for (int r = HALF_FULL; r < HALF_FULL + N_PARTIAL; ++r) {
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = gl::add(s[i], c_rc[r * WIDTH + i]);
    s[0] = sbox(s[0]);
    mds(s);
  }
#pragma unroll 1
  for (int r = HALF_FULL + N_PARTIAL; r < N_ROUNDS; ++r) full_round(s, r);
}

__global__ void __launch_bounds__(ROWS)
    hash_rows_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                     long long n, int w) {
  __shared__ uint64_t tile[ROWS * (RATE + 1)];
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int t = threadIdx.x;
  uint64_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = 0;
  const int nchunks = w > 0 ? (w + RATE - 1) / RATE : 1;
  for (int c = 0; c < nchunks; ++c) {
    const int cw = min(RATE, w - c * RATE);
    __syncthreads();  // the tile's previous chunk has been read
    for (int k = t; k < ROWS * cw; k += ROWS) {
      const int r = k / cw;
      const int j = k - r * cw;
      const long long g = row0 + r;
      tile[r * (RATE + 1) + j] = g < n ? in[g * w + (long long)c * RATE + j] : 0ull;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RATE; ++j)
      if (j < cw) s[j] = tile[t * (RATE + 1) + j];
    permute(s);
  }
  const long long g = row0 + t;
  if (g < n) {
#pragma unroll
    for (int i = 0; i < CAP; ++i) out[g * CAP + i] = s[i];
  }
}

__global__ void __launch_bounds__(ROWS)
    permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                   long long b) {
  __shared__ uint64_t tile[ROWS * (WIDTH + 1)];
  const long long base = (long long)blockIdx.x * ROWS * WIDTH;
  const long long total = b * WIDTH;
  const int t = threadIdx.x;
  for (int k = t; k < ROWS * WIDTH; k += ROWS) {
    const long long g = base + k;
    tile[(k / WIDTH) * (WIDTH + 1) + k % WIDTH] = g < total ? in[g] : 0ull;
  }
  __syncthreads();
  uint64_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = tile[t * (WIDTH + 1) + i];
  permute(s);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) tile[t * (WIDTH + 1) + i] = s[i];
  __syncthreads();
  for (int k = t; k < ROWS * WIDTH; k += ROWS) {
    const long long g = base + k;
    if (g < total) out[g] = tile[(k / WIDTH) * (WIDTH + 1) + k % WIDTH];
  }
}

}  // namespace

extern "C" {

// Copies the round constants (30 x 12) and the MDS matrix (12 x 12) into
// the current device's constant memory.  Call once per device before
// any launch.
int qzk_poseidon_init(const uint64_t* rc, const uint64_t* mds_matrix) {
  cudaError_t e = cudaMemcpyToSymbol(c_rc, rc, sizeof(c_rc));
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(c_mds, mds_matrix, sizeof(c_mds));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// in: (n, w) row-major, out: (n, 4); both on the device.
int qzk_hash_rows(const uint64_t* in, uint64_t* out, long long n, int w, void* stream) {
  const long long blocks = (n + ROWS - 1) / ROWS;
  hash_rows_kernel<<<(unsigned)blocks, ROWS, 0, (cudaStream_t)stream>>>(in, out, n, w);
  return (int)cudaGetLastError();
}

// in, out: (b, 12) row-major on the device.
int qzk_permute(const uint64_t* in, uint64_t* out, long long b, void* stream) {
  const long long blocks = (b + ROWS - 1) / ROWS;
  permute_kernel<<<(unsigned)blocks, ROWS, 0, (cudaStream_t)stream>>>(in, out, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
