// The zk blinding draw for Hopper (sm_90a): K8, threefry_draw.
//
// It replaces no TPU kernel.  The JAX package draws its blinding values
// with jax.random (Threefry-2x32 in XLA, qzk_tpu/plonk/prover.py); the
// port ran the same rounds as about 170 torch ops on int64 tensors a draw
// (ops/threefry.py::plain_bits_u64_shr1, which stays as this kernel's
// oracle).  Each of those ops gave up the interpreter lock and took it
// back, so a draw waited on every other thread of a shared prover about
// 170 times; here a draw is one launch.
//
// One draw of n elements, jax.random.bits(key, shape, "uint64") >> 1 in
// jax.random's partitionable mode: element i takes the counter words
// (i >> 32, i & 0xFFFFFFFF) through Threefry-2x32, 20 rounds under the key
// (k0, k1) with the schedule word k0 ^ k1 ^ 0x1BD11BDA and the rotations
// (13, 15, 26, 6), (17, 29, 16, 24), and stores
// ((uint64)x0 << 31) | (x1 >> 1): below 2^63 < p, a canonical field
// element.
//
// What bounds it on this card: it reads nothing and writes 8n bytes, and
// an element takes about 75 32-bit integer instructions (20 rounds of an
// add, a funnel shift and a xor; six key injections; the output's shifts
// and or).  At the prover's sizes (n = 2^18 for a leaf's salt, 2^20 for a
// chunk's) either bound is one or a few microseconds, below the launch's
// own cost.  The design keeps the host's part small and the stores wide:
//  - the key's two words are kernel arguments: no upload, no host round
//    trip, nothing to synchronise;
//  - rotations are funnel shifts, and the rounds unroll into straight-line
//    code with the rotation counts as immediates;
//  - a thread computes two consecutive elements and writes them with one
//    16-byte store, so a warp writes 512 contiguous bytes;
//  - a grid-stride loop over pairs with a 64-bit index covers any n; the
//    odd last element is written alone by the first thread.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
// Enough blocks to fill 132 SMs several times over; a larger draw loops.
constexpr long long MAX_BLOCKS = 4096;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds of one rotation group.
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = rotl(x1, R0) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R1) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R2) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R3) ^ x0;
}

// Element i of the draw under the key (k0, k1).
__device__ __forceinline__ uint64_t threefry_bits(uint32_t k0, uint32_t k1, uint64_t i) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)(i >> 32) + k0;
  uint32_t x1 = (uint32_t)i + k1;
  rounds4<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  rounds4<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  rounds4<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  rounds4<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  rounds4<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return ((uint64_t)x0 << 31) | (x1 >> 1);
}

__global__ void __launch_bounds__(THREADS)
threefry_draw_kernel(uint32_t k0, uint32_t k1, ulonglong2* __restrict__ out, long long n) {
  const long long pairs = n >> 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < pairs; p += stride) {
    const uint64_t i = 2ull * (uint64_t)p;
    out[p] = make_ulonglong2(threefry_bits(k0, k1, i), threefry_bits(k0, k1, i + 1));
  }
  if ((n & 1) && blockIdx.x == 0 && threadIdx.x == 0) {
    reinterpret_cast<uint64_t*>(out)[n - 1] = threefry_bits(k0, k1, (uint64_t)(n - 1));
  }
}

}  // namespace

extern "C" {

// The blocks of THREADS threads a draw of n elements launches.
long long qzk_threefry_blocks(long long n) {
  const long long blocks = ((n + 1) / 2 + THREADS - 1) / THREADS;
  return blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS;
}

// out: n int64 words on the device, 16-byte aligned.  Launches nothing
// for n <= 0.
int qzk_threefry_draw(unsigned k0, unsigned k1, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  threefry_draw_kernel<<<(unsigned)qzk_threefry_blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      k0, k1, reinterpret_cast<ulonglong2*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
