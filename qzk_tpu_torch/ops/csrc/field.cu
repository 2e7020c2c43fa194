// K4-K7: the Goldilocks field code of the prove path, hand-written for
// Hopper (sm_90a) on goldilocks.cuh.
//
// In the JAX package this code is XLA code (qzk_tpu/ops/goldilocks_jax.py):
// under jax.jit XLA fuses each field operation into one loop, and the
// scans of inverse and batch_inverse_axis run on the device.  Their plain
// torch version (ops/goldilocks_torch.py) launches about 25 kernels a
// multiply and one kernel chain a scan step.  Here one call is one launch
// (sum_mod past 2 * SUM_SMEM_WORDS elements along its axis: one more a
// halving, which qzk_sum_mod launches itself):
//
//   K4 field_map      add, sub, neg, mul, square, mul_small, reduce128 and
//                     ext_mul, one element a thread, over a broadcast of up
//                     to 4 dims by element strides (stride 0 on a broadcast
//                     dim), the output contiguous.  Replaces
//                     goldilocks_jax.py:47-113 and :238-248.  Bound: bytes,
//                     each operand's distinct words read once and the output
//                     written once, at 3.35 TB/s.
//   K5 field_inverse  inverse and ext_inverse_vec, one element a thread
//                     (the same 64-step Fermat walk, 0 -> 0), and
//                     batch_inverse_axis along a short axis, one lane a
//                     thread: the plain Montgomery algorithm (prefix, one
//                     Fermat, back-substitution), so a zero in a lane zeroes
//                     that lane's outputs as the plain version does.
//                     Replaces :129-150, :166-190 and :250-256.  Bound: the
//                     chain of dependent multiplies a thread (a lane's 2K
//                     prefix and back-substitution steps and the Fermat
//                     walk's 64 squarings), each at least two dependent
//                     32-bit multiply-adds.
//   K6 field_powers   powers_vec and ext_powers: output i = b^i, one output
//                     a thread, by square and multiply from b.  Replaces
//                     :153-163 and :258-268.  Bound: bytes; the function's
//                     n - 1 products (five 32-bit multiply-adds a field
//                     multiply, at 16.727e12 a second) take less.
//   K7 field_reduce   sum_mod along any axis, one block an output, in
//                     shared memory; and prefix_prod_exclusive along axis 0,
//                     one block a lane (a chunk a thread, then a scan of the
//                     chunks' products).  Replaces :192-227.  Bound: bytes.
//
// Bit-exact results.  Each output equals the plain version's bit for bit
// on every 64-bit input, canonical or not.  gl::mul's result is canonical
// and exact mod p for any inputs, so a product, a power or a prefix
// product has one value whatever the order of its factors: the kernels
// take the order that suits a thread, and only the words that the plain
// version leaves alone stay as they are (b^0 = 1, and a prefix product's
// output 0 = 1; its output 1 is mul(1, a[0]), canonical, as the plain
// version's mul(a[0], 1)).  gl::add is not exact on some non-canonical
// pairs, so sum_mod keeps the plain version's pairing: a[i] + a[i + n/2],
// with an odd tail added into element 0, level by level.
//
// The kernels launch on the caller's stream, allocate nothing (the
// wrapper, ops/goldilocks_cuda.py, passes outputs and scratch), never
// synchronise, and each C entry point returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_DIMS = 4;
constexpr int MAP_THREADS = 256;
constexpr int LANE_THREADS = 128;
constexpr long long MAX_BLOCKS = 1 << 16;
// sum_mod's shared words: the first halving of n <= 2 * SUM_SMEM_WORDS
// elements fits a block's 48 KB of static-limit shared memory.
constexpr long long SUM_SMEM_WORDS = 6144;

enum MapOp { ADD = 0, SUB, NEG, MUL, SQUARE, MUL_SMALL, REDUCE128, EXT_MUL };

// A row-major index space of nd <= MAX_DIMS dims (nd >= 1), and an
// operand's element strides over it.
struct Dims {
  int nd;
  long long n[MAX_DIMS];
};
struct Strides {
  long long s[MAX_DIMS];
};

// The offsets of flat index i in two operands; 32-bit divisions while
// the index fits them.  The loop unrolls, so that each dim's size and
// strides are read from the kernel's parameters at fixed offsets.
__device__ __forceinline__ void offsets(const Dims& d, const Strides& sa, const Strides& sb,
                                        long long i, long long& oa, long long& ob) {
  oa = 0;
  ob = 0;
#pragma unroll
  for (int k = MAX_DIMS - 1; k > 0; --k) {
    if (k >= d.nd) continue;
    const long long q = (unsigned long long)i >> 32
                            ? i / d.n[k]
                            : (long long)((unsigned)i / (unsigned)d.n[k]);
    const long long r = i - q * d.n[k];
    oa += r * sa.s[k];
    ob += r * sb.s[k];
    i = q;
  }
  oa += i * sa.s[0];
  ob += i * sb.s[0];
}

__device__ __forceinline__ uint64_t neg(uint64_t a) { return a == 0 ? 0 : gl::P - a; }

// (a0 + a1 x)(b0 + b1 x) with x^2 = 7: the plain ext_mul's operations.
__device__ __forceinline__ void ext_mul(uint64_t a0, uint64_t a1, uint64_t b0, uint64_t b1,
                                        uint64_t& c0, uint64_t& c1) {
  c0 = gl::add(gl::mul(a0, b0), gl::mul(gl::mul(a1, b1), 7));
  c1 = gl::add(gl::mul(a0, b1), gl::mul(a1, b0));
}

// a^(p-2) by the plain inverse's walk over the bits of p - 2; 0 -> 0.
__device__ __forceinline__ uint64_t inverse(uint64_t a) {
  constexpr uint64_t E = gl::P - 2;
  uint64_t result = 1, acc = a;
  for (int i = 0; i < 64; ++i) {
    if ((E >> i) & 1) result = gl::mul(result, acc);
    if (i < 63) acc = gl::mul(acc, acc);
  }
  return result;
}

__device__ __forceinline__ long long first_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_step() { return (long long)gridDim.x * blockDim.x; }

// ---- K4 ---------------------------------------------------------------------

template <int OP>
__global__ void __launch_bounds__(MAP_THREADS)
    field_map_kernel(const uint64_t* __restrict__ a, Strides sa, long long ca,
                     const uint64_t* __restrict__ b, Strides sb, long long cb, uint64_t c,
                     Dims d, long long n, uint64_t* __restrict__ out) {
  for (long long i = first_index(); i < n; i += grid_step()) {
    long long oa, ob;
    offsets(d, sa, sb, i, oa, ob);
    if (OP == EXT_MUL) {
      uint64_t c0, c1;
      ext_mul(a[oa], a[oa + ca], b[ob], b[ob + cb], c0, c1);
      out[2 * i] = c0;
      out[2 * i + 1] = c1;
      continue;
    }
    const uint64_t x = a[oa];
    uint64_t y;
    switch (OP) {
      case ADD: y = gl::add(x, b[ob]); break;
      case SUB: y = gl::sub(x, b[ob]); break;
      case NEG: y = neg(x); break;
      case MUL: y = gl::mul(x, b[ob]); break;
      case SQUARE: y = gl::mul(x, x); break;
      case MUL_SMALL: y = gl::mul(x, c); break;  // c < 2^32: the plain mul_small's product
      default: {  // REDUCE128: x the low word, b the high one
        const uint64_t hi = b[ob];
        const uint32_t r[4] = {(uint32_t)x, (uint32_t)(x >> 32), (uint32_t)hi,
                               (uint32_t)(hi >> 32)};
        y = gl::canonical(gl::reduce_weak(r));
      }
    }
    out[i] = y;
  }
}

// ---- K5 ---------------------------------------------------------------------

template <bool EXT>
__global__ void __launch_bounds__(MAP_THREADS)
    field_inverse_kernel(const uint64_t* __restrict__ a, Strides sa, long long ca, Dims d,
                         long long n, uint64_t* __restrict__ out) {
  for (long long i = first_index(); i < n; i += grid_step()) {
    long long oa, unused;
    offsets(d, sa, sa, i, oa, unused);
    if (!EXT) {
      out[i] = inverse(a[oa]);
      continue;
    }
    const uint64_t a0 = a[oa], a1 = a[oa + ca];
    const uint64_t inv = inverse(gl::sub(gl::mul(a0, a0), gl::mul(gl::mul(a1, a1), 7)));
    out[2 * i] = gl::mul(a0, inv);
    out[2 * i + 1] = gl::mul(neg(a1), inv);
  }
}

// One lane a thread: a lane is the k words a[lane + j * a_axis], and its
// outputs out[lane' + j * o_axis].  The prefix products go to the output
// first, then the back-substitution turns each into its inverse.
__global__ void __launch_bounds__(LANE_THREADS)
    batch_inverse_kernel(const uint64_t* __restrict__ a, Strides sa, long long a_axis, Dims d,
                         long long lanes, Strides so, long long o_axis, long long k,
                         uint64_t* __restrict__ out) {
  for (long long lane = first_index(); lane < lanes; lane += grid_step()) {
    long long ia, io;
    offsets(d, sa, so, lane, ia, io);
    const uint64_t* x = a + ia;
    uint64_t* y = out + io;
    uint64_t acc = 1;
    for (long long j = 0; j < k; ++j) {
      y[j * o_axis] = acc;
      acc = gl::mul(acc, x[j * a_axis]);
    }
    uint64_t inv = inverse(acc);
    for (long long j = k - 1; j >= 0; --j) {
      y[j * o_axis] = gl::mul(inv, y[j * o_axis]);
      if (j) inv = gl::mul(inv, x[j * a_axis]);
    }
  }
}

// ---- K6 ---------------------------------------------------------------------

template <bool EXT>
__global__ void __launch_bounds__(MAP_THREADS)
    field_powers_kernel(const uint64_t* __restrict__ b, long long cb, long long n,
                        uint64_t* __restrict__ out) {
  for (long long i = first_index(); i < n; i += grid_step()) {
    uint64_t r0 = 1, r1 = 0, b0 = b[0], b1 = EXT ? b[cb] : 0;
    for (long long e = i; e; e >>= 1) {
      if (e & 1) {
        if (EXT) ext_mul(r0, r1, b0, b1, r0, r1);
        else r0 = gl::mul(r0, b0);
      }
      if (e > 1) {
        if (EXT) ext_mul(b0, b1, b0, b1, b0, b1);
        else b0 = gl::mul(b0, b0);
      }
    }
    if (EXT) {
      out[2 * i] = r0;
      out[2 * i + 1] = r1;
    } else {
      out[i] = r0;
    }
  }
}

// ---- K7 ---------------------------------------------------------------------

// One halving step of the plain sum_mod at index i < h = n / 2, over
// words x[j * st]: x[i] + x[i + h], plus x[n - 1] at i = 0 when n is odd.
__device__ __forceinline__ uint64_t halve_at(const uint64_t* x, long long st, long long i,
                                             long long h, long long n) {
  uint64_t v = gl::add(x[i * st], x[(i + h) * st]);
  if (i == 0 && (n & 1)) v = gl::add(v, x[(n - 1) * st]);
  return v;
}

// One halving of every lane into out, (lanes, n / 2) row-major: the
// first steps of a sum too long for one block's shared memory.
__global__ void __launch_bounds__(MAP_THREADS)
    sum_halve_kernel(const uint64_t* __restrict__ a, Strides sa, long long a_axis, Dims d,
                     long long lanes, long long n, uint64_t* __restrict__ out) {
  const long long h = n / 2;
  for (long long idx = first_index(); idx < lanes * h; idx += grid_step()) {
    const long long lane = idx / h;
    long long ia, unused;
    offsets(d, sa, sa, lane, ia, unused);
    out[idx] = halve_at(a + ia, a_axis, idx - lane * h, h, n);
  }
}

// One block a lane: the first halving from device memory into shared
// memory, then every later one in place (a step writes words below h and
// reads only its own word there), a barrier between steps.
__global__ void __launch_bounds__(MAP_THREADS)
    sum_block_kernel(const uint64_t* __restrict__ a, Strides sa, long long a_axis, Dims d,
                     long long lanes, long long n, uint64_t* __restrict__ out) {
  extern __shared__ uint64_t s[];
  const long long t = threadIdx.x, T = blockDim.x;
  for (long long lane = blockIdx.x; lane < lanes; lane += gridDim.x) {
    long long ia, unused;
    offsets(d, sa, sa, lane, ia, unused);
    const uint64_t* x = a + ia;
    if (n < 2) {  // the plain version: zeros for n = 0, a[..., 0] for n = 1
      if (t == 0) out[lane] = n ? x[0] : 0;
      continue;
    }
    const long long m = n / 2;
    for (long long i = t; i < m; i += T) s[i] = halve_at(x, a_axis, i, m, n);
    for (long long len = m; len > 1; len /= 2) {
      __syncthreads();
      const long long h = len / 2;
      for (long long i = t; i < h; i += T) s[i] = halve_at(s, 1, i, h, len);
    }
    __syncthreads();
    if (t == 0) out[lane] = s[0];
    __syncthreads();  // s[0] is read before the next lane writes it
  }
}

// One block a lane of n >= 1 words along axis 0: each thread multiplies a
// chunk of ceil(n / T) words, an inclusive scan (Hillis-Steele, in
// shared memory) gives each chunk the product of those before it, and
// each thread writes its chunk's exclusive products from there.
__global__ void __launch_bounds__(1024)
    prefix_prod_kernel(const uint64_t* __restrict__ a, Strides sa, long long a_axis, Dims d,
                       long long lanes, Strides so, long long o_axis, long long n,
                       uint64_t* __restrict__ out) {
  extern __shared__ uint64_t tot[];
  const long long t = threadIdx.x, T = blockDim.x;
  const long long chunk = (n + T - 1) / T;
  const long long lo = t * chunk < n ? t * chunk : n;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  for (long long lane = blockIdx.x; lane < lanes; lane += gridDim.x) {
    long long ia, io;
    offsets(d, sa, so, lane, ia, io);
    const uint64_t* x = a + ia;
    uint64_t* y = out + io;
    uint64_t p = 1;
    for (long long j = lo; j < hi; ++j) p = gl::mul(p, x[j * a_axis]);
    tot[t] = p;
    for (long long k = 1; k < T; k *= 2) {
      __syncthreads();
      const uint64_t left = t >= k ? tot[t - k] : 1;
      __syncthreads();
      if (t >= k) tot[t] = gl::mul(tot[t], left);
    }
    __syncthreads();
    uint64_t run = t ? tot[t - 1] : 1;
    for (long long j = lo; j < hi; ++j) {
      y[j * o_axis] = run;
      run = gl::mul(run, x[j * a_axis]);
    }
    __syncthreads();  // tot is read before the next lane writes it
  }
}

// ---- launch helpers -------------------------------------------------------

bool make_dims(int nd, const long long* shape, Dims& d, long long& n) {
  if (nd < 1 || nd > MAX_DIMS) return false;
  d.nd = nd;
  n = 1;
  for (int k = 0; k < MAX_DIMS; ++k) {
    d.n[k] = k < nd ? shape[k] : 1;
    n *= d.n[k];
  }
  return true;
}

Strides make_strides(int nd, const long long* s) {
  Strides st;
  for (int k = 0; k < MAX_DIMS; ++k) st.s[k] = s != nullptr && k < nd ? s[k] : 0;
  return st;
}

unsigned blocks_for(long long work, int threads) {
  const long long b = (work + threads - 1) / threads;
  return (unsigned)(b < 1 ? 1 : b > MAX_BLOCKS ? MAX_BLOCKS : b);
}

unsigned lane_blocks(long long lanes) {
  return (unsigned)(lanes < 1 ? 1 : lanes > MAX_BLOCKS ? MAX_BLOCKS : lanes);
}

template <int OP>
int launch_map(const uint64_t* a, Strides sa, long long ca, const uint64_t* b, Strides sb,
               long long cb, uint64_t c, Dims d, long long n, uint64_t* out,
               cudaStream_t stream) {
  const unsigned blocks = blocks_for(n, MAP_THREADS);
  field_map_kernel<OP><<<blocks, MAP_THREADS, 0, stream>>>(a, sa, ca, b, sb, cb, c, d, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: out (contiguous) = op(a, b) over the index space `shape` (nd dims),
// a and b read at their element strides sa, sb (b and sb unused by the
// unary ops); ca, cb: the component strides of EXT_MUL's operands; c:
// MUL_SMALL's constant.
int qzk_field_map(int op, const uint64_t* a, const long long* sa, long long ca,
                  const uint64_t* b, const long long* sb, long long cb, unsigned long long c,
                  int nd, const long long* shape, uint64_t* out, void* stream) {
  Dims d;
  long long n;
  if (!make_dims(nd, shape, d, n)) return (int)cudaErrorInvalidValue;
  const Strides A = make_strides(nd, sa), B = make_strides(nd, sb);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case ADD: return launch_map<ADD>(a, A, ca, b, B, cb, c, d, n, out, s);
    case SUB: return launch_map<SUB>(a, A, ca, b, B, cb, c, d, n, out, s);
    case NEG: return launch_map<NEG>(a, A, ca, a, A, cb, c, d, n, out, s);
    case MUL: return launch_map<MUL>(a, A, ca, b, B, cb, c, d, n, out, s);
    case SQUARE: return launch_map<SQUARE>(a, A, ca, a, A, cb, c, d, n, out, s);
    case MUL_SMALL: return launch_map<MUL_SMALL>(a, A, ca, a, A, cb, c, d, n, out, s);
    case REDUCE128: return launch_map<REDUCE128>(a, A, ca, b, B, cb, c, d, n, out, s);
    case EXT_MUL: return launch_map<EXT_MUL>(a, A, ca, b, B, cb, c, d, n, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5, element by element: out = inverse(a), or with ext set, the
// extension inverse of (a, a + ca) into out's pairs.
int qzk_field_inverse(int ext, const uint64_t* a, const long long* sa, long long ca, int nd,
                      const long long* shape, uint64_t* out, void* stream) {
  Dims d;
  long long n;
  if (!make_dims(nd, shape, d, n)) return (int)cudaErrorInvalidValue;
  const Strides A = make_strides(nd, sa);
  const unsigned blocks = blocks_for(n, MAP_THREADS);
  const cudaStream_t s = (cudaStream_t)stream;
  if (ext)
    field_inverse_kernel<true><<<blocks, MAP_THREADS, 0, s>>>(a, A, ca, d, n, out);
  else
    field_inverse_kernel<false><<<blocks, MAP_THREADS, 0, s>>>(a, A, ca, d, n, out);
  return (int)cudaGetLastError();
}

// K5, batch_inverse_axis: lanes over `shape` at strides sa (input) and so
// (output), k words a lane at a_axis and o_axis.
int qzk_batch_inverse(const uint64_t* a, const long long* sa, long long a_axis, int nd,
                      const long long* shape, const long long* so, long long o_axis, long long k,
                      uint64_t* out, void* stream) {
  Dims d;
  long long lanes;
  if (!make_dims(nd, shape, d, lanes)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = blocks_for(lanes, LANE_THREADS);
  batch_inverse_kernel<<<blocks, LANE_THREADS, 0, (cudaStream_t)stream>>>(
      a, make_strides(nd, sa), a_axis, d, lanes, make_strides(nd, so), o_axis, k, out);
  return (int)cudaGetLastError();
}

// K6: out[i] = b^i for i < n; with ext set, the extension powers of
// (b[0], b[cb]) into out's pairs.
int qzk_field_powers(int ext, const uint64_t* b, long long cb, long long n, uint64_t* out,
                     void* stream) {
  const unsigned blocks = blocks_for(n, MAP_THREADS);
  if (ext)
    field_powers_kernel<true><<<blocks, MAP_THREADS, 0, (cudaStream_t)stream>>>(b, cb, n, out);
  else
    field_powers_kernel<false><<<blocks, MAP_THREADS, 0, (cudaStream_t)stream>>>(b, cb, n, out);
  return (int)cudaGetLastError();
}

// K7, sum_mod: the halvings before the block sum of a lane of n words,
// and the scratch words they take.  A lane longer than 2 * SUM_SMEM_WORDS
// is halved into scratch, one launch a halving, alternating between two
// regions (lanes * (n / 2) words, then lanes * (n / 4)), until the block
// sum's shared memory holds its first halving.  Returns the launches of
// one qzk_sum_mod call.
int qzk_sum_plan(long long lanes, long long n, long long* scratch_words) {
  long long halvings = 0, words = 0, region = 0;
  for (long long m = n; m > 2 * SUM_SMEM_WORDS; m /= 2, ++halvings) {
    region = lanes * (m / 2);
    if (halvings < 2) words += region;
  }
  *scratch_words = words;
  return (int)(halvings + 1);
}

// K7, sum_mod: out[lane] = the plain sum_mod of the lane's n words, the
// lanes over `shape` at strides sa, a lane's words at a_axis; scratch:
// qzk_sum_plan's words (unused, and may be null, when it asks for none).
int qzk_sum_mod(const uint64_t* a, const long long* sa, long long a_axis, int nd,
                const long long* shape, long long n, uint64_t* scratch, uint64_t* out,
                void* stream) {
  Dims d;
  long long lanes;
  if (!make_dims(nd, shape, d, lanes) || n < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Strides st = make_strides(nd, sa);
  uint64_t* region[2] = {scratch, scratch};
  for (long long m = n, k = 0; m > 2 * SUM_SMEM_WORDS; m /= 2, ++k) {
    if (k == 0) region[1] = scratch + lanes * (m / 2);
    uint64_t* half = region[k & 1];
    sum_halve_kernel<<<blocks_for(lanes * (m / 2), MAP_THREADS), MAP_THREADS, 0, s>>>(
        a, st, a_axis, d, lanes, m, half);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // The next step reads the half as (lanes, m / 2), row-major.
    const long long rows = lanes, row = m / 2;
    make_dims(1, &rows, d, lanes);
    st = make_strides(1, &row);
    a = half, n = row, a_axis = 1;
  }
  int threads = 32;
  while (threads < MAP_THREADS && threads < n / 2) threads *= 2;
  sum_block_kernel<<<lane_blocks(lanes), threads, (size_t)(n / 2) * 8, s>>>(a, st, a_axis, d,
                                                                            lanes, n, out);
  return (int)cudaGetLastError();
}

// K7, prefix_prod_exclusive: the threads of qzk_prefix_prod's block for a
// lane of n words, 32 to 1024: eight words or more a thread up to 8192.
int qzk_prefix_threads(long long n) {
  int threads = 32;
  while (threads < 1024 && 8LL * threads <= n) threads *= 2;
  return threads;
}

// K7, prefix_prod_exclusive: lanes over `shape` at strides sa and so, n
// >= 1 words a lane at a_axis and o_axis, one block of
// qzk_prefix_threads(n) threads a lane.
int qzk_prefix_prod(const uint64_t* a, const long long* sa, long long a_axis, int nd,
                    const long long* shape, const long long* so, long long o_axis, long long n,
                    uint64_t* out, void* stream) {
  Dims d;
  long long lanes;
  if (!make_dims(nd, shape, d, lanes) || n < 1) return (int)cudaErrorInvalidValue;
  const int threads = qzk_prefix_threads(n);
  prefix_prod_kernel<<<lane_blocks(lanes), threads, (size_t)threads * 8, (cudaStream_t)stream>>>(
      a, make_strides(nd, sa), a_axis, d, lanes, make_strides(nd, so), o_axis, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
