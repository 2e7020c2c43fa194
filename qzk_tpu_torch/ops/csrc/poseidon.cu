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
// What bounds them on this card: the throughput of 32-bit integer
// instructions.  One permutation is 30 rounds; a full round takes 12
// S-boxes of 4 field products, a partial round 1, and every round an MDS
// layer of 144 small products on each 32-bit half of the state.  K1
// reads only n*w*8 bytes (and writes n*32), so the state stays in
// registers, each input word is read once, and a block stages its rows'
// current 8-column chunk through shared memory so that a warp reads
// consecutive addresses.  The design cuts instructions:
//  - the MDS entries are immediates, and each term is one mad.wide.u32;
//  - the field product and its reduction are PTX carry chains
//    (goldilocks.cuh);
//  - inside the permutation a lane holds any 64-bit word congruent to
//    its value mod p, and only its output is made canonical.  Every step
//    is exact mod p on every 64-bit input, and so is the plain version,
//    whose outputs are canonical: the outputs agree bit for bit on every
//    input.
// The round constants sit in __constant__ memory, where every thread of
// a warp reads the same word at once.
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
// Four blocks an SM leave 128 registers a thread, which both kernels
// meet without spilling (nvcc -Xptxas -v).
constexpr int MIN_BLOCKS = 4;

__constant__ uint64_t c_rc[N_ROUNDS * WIDTH];

// The MDS matrix M[r][c] = MDS_CIRC[(c - r) mod 12] + (r == c) * MDS_DIAG[r]
// (ops/poseidon.py), as compile-time immediates: under full unrolling
// every entry folds into the multiply instruction that uses it.
__device__ __forceinline__ uint32_t mds_entry(int r, int c) {
  constexpr uint32_t MDS_CIRC[WIDTH] = {17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20};
  constexpr uint32_t MDS_DIAG[WIDTH] = {8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  return MDS_CIRC[(c - r + WIDTH) % WIDTH] + (r == c ? MDS_DIAG[r] : 0u);
}

// x * m + acc as one 32 x 32 + 64 -> 64-bit multiply-add.  Written in
// PTX because the C++ form let the compiler turn the powers of two into
// shift sequences and add high words of zero that it failed to fold.
__device__ __forceinline__ uint64_t mad_wide(uint32_t x, uint32_t m, uint64_t acc) {
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(x), "r"(m), "l"(acc));
  return r;
}

// a + c mod p, weakly, for a round constant c < p: on a carry the sum
// a + c - 2^64 + eps stays below 2^64.
__device__ __forceinline__ uint64_t add_rc(uint64_t a, uint64_t c) {
  const uint64_t s = a + c;
  return s < a ? s + gl::EPS : s;
}

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl::mul_weak(x, x);
  const uint64_t x3 = gl::mul_weak(x2, x);
  const uint64_t x4 = gl::mul_weak(x2, x2);
  return gl::mul_weak(x4, x3);
}

// s[r] <- sum_c M[r][c] * s[c] mod p, weakly.  The sum is taken exactly
// over the 32-bit halves of the lanes (as ops/poseidon_torch.py
// mds_layer does), each half-sum below 2^42, and reduced once per lane.
// The state is split into its halves first and each output lane is
// written back in place, so no second 12-lane array stays live.
__device__ __forceinline__ void mds(uint64_t s[WIDTH]) {
  uint32_t lo[WIDTH], hi[WIDTH];
#pragma unroll
  for (int c = 0; c < WIDTH; ++c) {
    lo[c] = (uint32_t)s[c];
    hi[c] = (uint32_t)(s[c] >> 32);
  }
#pragma unroll
  for (int r = 0; r < WIDTH; ++r) {
    uint64_t sum_lo = 0, sum_hi = 0;
#pragma unroll
    for (int c = 0; c < WIDTH; ++c) {
      const uint32_t m = mds_entry(r, c);
      sum_lo = mad_wide(lo[c], m, sum_lo);
      sum_hi = mad_wide(hi[c], m, sum_hi);
    }
    // sum_lo + sum_hi 2^32 as lo64 + hi64 2^64, hi64 below 2^10
    const uint64_t lo64 = sum_lo + (sum_hi << 32);
    const uint64_t hi64 = (sum_hi >> 32) + (lo64 < sum_lo ? 1ull : 0ull);
    s[r] = gl::reduce96_weak(lo64, (uint32_t)hi64);
  }
}

__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox(add_rc(s[i], c_rc[r * WIDTH + i]));
  mds(s);
}

// The 30 rounds, weakly.
__device__ void rounds(uint64_t s[WIDTH]) {
#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) full_round(s, r);
#pragma unroll 1
  for (int r = HALF_FULL; r < HALF_FULL + N_PARTIAL; ++r) {
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = add_rc(s[i], c_rc[r * WIDTH + i]);
    s[0] = sbox(s[0]);
    mds(s);
  }
#pragma unroll 1
  for (int r = HALF_FULL + N_PARTIAL; r < N_ROUNDS; ++r) full_round(s, r);
}

// The permutation of any 64-bit words, canonical out.
__device__ __forceinline__ void permute(uint64_t s[WIDTH]) {
  rounds(s);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = gl::canonical(s[i]);
}

__global__ void __launch_bounds__(ROWS, MIN_BLOCKS)
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

__global__ void __launch_bounds__(ROWS, MIN_BLOCKS)
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

// Copies the round constants (30 x 12) into the current device's
// constant memory.  Call once per device before any launch.
int qzk_poseidon_init(const uint64_t* rc) {
  cudaError_t e = cudaMemcpyToSymbol(c_rc, rc, sizeof(c_rc));
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
