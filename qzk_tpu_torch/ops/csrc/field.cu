// K4-K7: the Goldilocks field code of the prove path, hand-written for
// Hopper (sm_90a) on goldilocks.cuh.
//
// In the JAX package this code is XLA code (qzk_tpu/ops/goldilocks_jax.py
// and the Poseidon gate's round walk in qzk_tpu/plonk/gates.py): under
// jax.jit XLA fuses each field operation into one loop, and the scans of
// inverse and batch_inverse_axis run on the device.  Their plain torch
// version (ops/goldilocks_torch.py, and ops/poseidon_torch.py for the
// gate's MDS layer) launches about 25 kernels a multiply and one kernel
// chain a scan step.  Here one call is one launch (sum_mod and dot_mod
// past the shared memory of one block: one more a halving, which
// qzk_sum_mod launches itself):
//
//   K4 field_map      add, sub, neg, mul, square, mul_small, reduce128,
//                     ext_mul and pow7 over a broadcast of up to 4 dims by
//                     element strides (stride 0 on a broadcast dim), the
//                     output contiguous; and the Poseidon gate's round,
//                     mds_full (the MDS layer of x^7 over a (12, M)
//                     state) and mds_partial (x^7 on row 0 only, rows
//                     1-11 from a second operand).  Replaces
//                     goldilocks_jax.py:47-113, :238-248 and the gate's
//                     mds / x7 (qzk_tpu/plonk/gates.py:489-500).  Bound:
//                     bytes, each operand's distinct words read once and
//                     the output written once, at 3.35 TB/s.
//                     Design: the layouts that carry almost every call
//                     (one flat dim; (rows, cols) with an operand
//                     broadcast along either dim) take a path with no
//                     division an element, 32-bit offsets, two words a
//                     thread by 16-byte accesses where base and strides
//                     allow, and a grid of at most 8 blocks an SM walking
//                     the work; a round is one launch, its 144 small MDS
//                     products immediates of the code.
//   K5 field_inverse  inverse and ext_inverse_vec, one element a thread,
//                     and batch_inverse_axis and batch_divide_axis (nums
//                     times the batch inverse of dens) along a short
//                     axis.  Replaces :129-150, :166-190 and :250-256, and
//                     the zs stage's multiply after the batch inverse
//                     (qzk_tpu/plonk/device_prover.py:414).  Design: the
//                     Fermat inverse is plonky2's addition chain for p - 2
//                     (63 squarings and 9 multiplies, where the plain walk
//                     takes 127; 0 -> 0).  A lane of k words takes a group
//                     of G threads (16 for the prove's k = 80), and a block
//                     of 256 threads 256 / G lanes: the block's tile moves
//                     through shared memory with neighbouring threads on
//                     neighbouring addresses, whether a lane's words or the
//                     lanes are contiguous; a thread multiplies its k / G
//                     words in registers, a prefix and a suffix scan of the
//                     group's products (in shared memory, log2 G steps)
//                     give the lane's total, and the block's first threads
//                     invert their lanes' totals (one Fermat a lane, so a
//                     zero in a lane zeroes that lane's outputs and no
//                     other's, as in the plain version; packed, so that one
//                     warp issues the chain for 32 lanes); each thread
//                     back-substitutes its words.  No prefix goes to device
//                     memory: each word is read once and each output
//                     written once.  Bound: bytes (dens, nums and the
//                     output).  The dependent chain (k / G words each way,
//                     log2 G scan steps and the chain's 72 multiplies) is
//                     longer on an H100: a launch at the prove's (8192, 80)
//                     takes about twice the time of one Fermat chain a
//                     thread over (65536, 2) (ext_inverse_vec's; PERF.md).
//   K6 field_powers   powers_vec and ext_powers, and their multi-base forms
//                     (up to MAX_BASES bases in one launch, out (B, n) or
//                     (B, n, 2)).  Replaces :153-163 and :258-268.
//                     Design: a block builds b^j (j < 2^s) and (b^(2^s))^q
//                     (q < 2^u) in shared memory by the plain doubling
//                     steps, and output i is their product at (i mod 2^s,
//                     i >> s): a chain of about log2 n + 1 multiplies.
//                     Bound: bytes; the function's n - 1 products a base
//                     (five 32-bit multiply-adds a field multiply, at
//                     16.727e12 a second) take less.
//   K7 field_reduce   sum_mod and dot_mod (sum_mod of a product by a
//                     weight broadcast along the other dims, the product
//                     formed as it is read and never written) along any
//                     axis; prod_chunks (the product of each run of
//                     `chunk` words along an axis, the last run ragged);
//                     and prefix_prod_exclusive along axis 0, one block a
//                     lane (a chunk a thread, then a scan of the chunks'
//                     products).  Replaces :192-227 and the permutation
//                     argument's chunk products (qzk_tpu/plonk/
//                     vanishing.py:140-161, device_prover.py:415-431).
//                     Bound: bytes.  Design: a sum whose lanes are
//                     neighbouring words (along axis 0 of (S, M)) runs a
//                     tile of 32 lanes a block, so that a warp reads 32
//                     consecutive words of a row, the first halving in
//                     registers and the later ones in shared memory laid
//                     out [row][lane]; a sum along contiguous words runs
//                     one block a lane.
//
// Bit-exact results.  Each output equals the plain version's bit for bit
// on every 64-bit input, canonical or not.  gl::mul's result is canonical
// and exact mod p for any inputs, so a product, a power or a prefix
// product has one value whatever the order of its factors: the kernels
// take the order that suits a thread, and only the words that the plain
// version leaves alone stay as they are (b^0 = 1, a prefix product's
// output 0 = 1, and a run of one word in prod_chunks; a prefix product's
// output 1 is mul(1, a[0]), canonical, as the plain version's mul(a[0],
// 1)).  gl::add is not exact on some non-canonical pairs, so sum_mod and
// dot_mod keep the plain version's pairing: a[i] + a[i + n/2], with an
// odd tail added into element 0, level by level.  The MDS layer is the
// plain version's exact small-integer sums of the words' 32-bit halves
// and its reduce128, so it gives the plain words on any input.
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
// batch_inverse_axis: a block of BATCH_THREADS threads, G a lane (G <=
// BATCH_THREADS, by default the least power of two that leaves a thread
// at most BATCH_WORDS words of its lane).
constexpr int BATCH_THREADS = 256;
constexpr int BATCH_WORDS = 5;
// Blocks an SM that the batch kernel's registers must allow: (8192, 80)
// at 16 threads a lane is 512 blocks, one wave at 4 an SM on 132 SMs.
constexpr int BATCH_MIN_BLOCKS = 4;
// powers: bases a launch, threads a block, and the most powers a base
// (two tables of 2^12 entries at most).
constexpr int MAX_BASES = 8;
constexpr int POW_THREADS = 256;
constexpr int POW_MAX_LOG_N = 24;
constexpr long long MAX_BLOCKS = 1 << 16;
// The fast map path's grid: at most this many blocks of MAP_THREADS an SM.
constexpr int MAP_BLOCKS_PER_SM = 8;
// sum_mod's shared words: the first halving of a lane (one block a lane)
// or of a tile of SUM_TILE lanes (one block a tile) fits a block's 48 KB
// of static-limit shared memory.
constexpr long long SUM_SMEM_WORDS = 6144;
constexpr int SUM_TILE = 32;
constexpr int WIDTH = 12;  // the Poseidon state

enum MapOp { ADD = 0, SUB, NEG, MUL, SQUARE, MUL_SMALL, REDUCE128, EXT_MUL, POW7 };

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

// The same product weakly, for any 64-bit words: each component some word
// congruent to the exact value (the sums by add_weak, exact mod p on any
// words, and 7 t as a 67-bit product reduced weakly).
__device__ __forceinline__ void ext_mul_weak(uint64_t a0, uint64_t a1, uint64_t b0, uint64_t b1,
                                             uint64_t& c0, uint64_t& c1) {
  const uint64_t t = gl::mul_weak(a1, b1);
  const uint32_t t7_hi = (uint32_t)(((t >> 32) * 7 + (((t & 0xFFFFFFFFull) * 7) >> 32)) >> 32);
  c0 = gl::add_weak(gl::mul_weak(a0, b0), gl::reduce96_weak(t * 7, t7_hi));
  c1 = gl::add_weak(gl::mul_weak(a0, b1), gl::mul_weak(a1, b0));
}

// x^7, the S-box: x^2, x^3 = x^2 x, x^7 = (x^2)^2 x^3 as the plain x7,
// weakly in between; the canonical value of the exact product at the end
// is the plain version's word.
__device__ __forceinline__ uint64_t pow7(uint64_t x) {
  const uint64_t x2 = gl::mul_weak(x, x);
  const uint64_t x3 = gl::mul_weak(x2, x);
  return gl::canonical(gl::mul_weak(gl::mul_weak(x2, x2), x3));
}

// hi 2^64 + lo into [0, p): the plain reduce128.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  const uint32_t r[4] = {(uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32)};
  return gl::canonical(gl::reduce_weak(r));
}

// t^(2^k), weakly.
__device__ __forceinline__ uint64_t square_n(uint64_t t, int k) {
  for (int i = 0; i < k; ++i) t = gl::mul_weak(t, t);
  return t;
}

// a^(p-2) by plonky2's addition chain for p - 2: 63 squarings and 9
// multiplies, weakly in between (t_k = a^(2^k - 1)); 0 -> 0.  With t63 =
// t31^(2^32) t31 = a^((2^31 - 1)(2^32 + 1)), t63^2 a = a^(2^64 - 2^32 - 1)
// = a^(p-2).  gl::mul is exact, so the canonical value at the end is the
// plain walk's word.
__device__ __forceinline__ uint64_t inverse(uint64_t a) {
  const uint64_t t2 = gl::mul_weak(gl::mul_weak(a, a), a);
  const uint64_t t3 = gl::mul_weak(gl::mul_weak(t2, t2), a);
  const uint64_t t6 = gl::mul_weak(square_n(t3, 3), t3);
  const uint64_t t12 = gl::mul_weak(square_n(t6, 6), t6);
  const uint64_t t24 = gl::mul_weak(square_n(t12, 12), t12);
  const uint64_t t30 = gl::mul_weak(square_n(t24, 6), t6);
  const uint64_t t31 = gl::mul_weak(gl::mul_weak(t30, t30), a);
  const uint64_t t63 = gl::mul_weak(square_n(t31, 32), t31);
  return gl::canonical(gl::mul_weak(gl::mul_weak(t63, t63), a));
}

__device__ __forceinline__ long long first_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_step() { return (long long)gridDim.x * blockDim.x; }

// ---- K4 ---------------------------------------------------------------------

// One word of a map op: x from the first operand, y from the second (the
// unary ops ignore it), c MUL_SMALL's constant.
template <int OP>
__device__ __forceinline__ uint64_t map_one(uint64_t x, uint64_t y, uint64_t c) {
  switch (OP) {
    case ADD: return gl::add(x, y);
    case SUB: return gl::sub(x, y);
    case NEG: return neg(x);
    case MUL: return gl::mul(x, y);
    case SQUARE: return gl::mul(x, x);
    case MUL_SMALL: return gl::mul(x, c);  // c < 2^32: the plain mul_small's product
    case POW7: return pow7(x);
    default: return reduce128(x, y);  // REDUCE128: x the low word, y the high one
  }
}

// The general path: any broadcast of up to 4 dims, one element a thread.
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
    out[i] = map_one<OP>(a[oa], b[ob], c);
  }
}

// The fast path's index space: rows x cols, every offset below 2^31.  An
// operand's word (row, col) lies at row * r + col * c, with c 0 (broadcast
// along a row) or 1; the output is contiguous.  A block covers rpb rows
// of 2^log_tpr threads each; a thread takes VEC words of a row.
struct Fast2 {
  unsigned rows, cols;
  unsigned ra, rb;
  unsigned ca, cb;
  int log_tpr;
};

// VEC consecutive words of an operand's row from col (16 bytes when VEC
// is 2 and the operand steps along the row; one word repeated when it is
// broadcast along it).
template <int VEC>
__device__ __forceinline__ void load_vec(const uint64_t* __restrict__ p, unsigned c, unsigned col,
                                         uint64_t v[VEC]) {
  if (VEC == 2 && c) {
    const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(p + col);
    v[0] = w.x;
    v[VEC - 1] = w.y;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = p[c ? col + k : 0];
  }
}

template <int OP, int VEC>
__global__ void __launch_bounds__(MAP_THREADS)
    field_map_fast_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                          uint64_t c, Fast2 f, uint64_t* __restrict__ out) {
  const unsigned tpr = 1u << f.log_tpr, rpb = blockDim.x >> f.log_tpr;
  const unsigned col0 = (blockIdx.x * tpr + (threadIdx.x & (tpr - 1))) * VEC;
  const unsigned col_step = gridDim.x * tpr * VEC;
  for (unsigned row = blockIdx.y * rpb + (threadIdx.x >> f.log_tpr); row < f.rows;
       row += gridDim.y * rpb) {
    const uint64_t* ar = a + row * f.ra;
    const uint64_t* br = b + row * f.rb;
    uint64_t* orow = out + row * f.cols;
    for (unsigned col = col0; col < f.cols; col += col_step) {
      if (VEC == 2 && col + 1 < f.cols) {
        uint64_t x[2], y[2];
        load_vec<2>(ar, f.ca, col, x);
        load_vec<2>(br, f.cb, col, y);
        ulonglong2 o;
        o.x = map_one<OP>(x[0], y[0], c);
        o.y = map_one<OP>(x[1], y[1], c);
        *reinterpret_cast<ulonglong2*>(orow + col) = o;
      } else {  // one word (VEC 1, or the odd tail of a row)
        orow[col] = map_one<OP>(ar[f.ca ? col : 0], br[f.cb ? col : 0], c);
      }
    }
  }
}

// The MDS matrix M[r][c] = MDS_CIRC[(c - r) mod 12] + (r == c) * MDS_DIAG[r]
// of ops/poseidon.py; under full unrolling each entry is an immediate.
__device__ __forceinline__ uint32_t mds_entry(int r, int c) {
  constexpr uint32_t MDS_CIRC[WIDTH] = {17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20};
  constexpr uint32_t MDS_DIAG[WIDTH] = {8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  return MDS_CIRC[(c - r + WIDTH) % WIDTH] + (r == c ? MDS_DIAG[r] : 0u);
}

// The Poseidon gate's round for column j of a (12, m) state: s[i] =
// x[i][j]^7 (FULL) or, for a partial round, s[0] = x0[j]^7 and s[i] =
// x[i][j] for i >= 1; then out[r][j] = reduce128 of the exact sum of
// M[r][i] s[i] over the words' 32-bit halves (each half-sum below 2^42),
// the plain mds's operations.  One column a thread, its 12 loads in
// flight together, the rows read and written at neighbouring columns by
// neighbouring threads.  (Twelve threads a column, exchanging the S-box
// outputs through shared memory, ran slower on an H100.)
template <bool FULL>
__global__ void __launch_bounds__(MAP_THREADS)
    mds_kernel(const uint64_t* __restrict__ x, long long xr, long long xc,
               const uint64_t* __restrict__ x0, long long x0c, long long m,
               uint64_t* __restrict__ out) {
  for (long long j = first_index(); j < m; j += grid_step()) {
    uint32_t lo[WIDTH], hi[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
      uint64_t v;
      if (FULL) v = pow7(x[i * xr + j * xc]);
      else v = i ? x[i * xr + j * xc] : pow7(x0[j * x0c]);
      lo[i] = (uint32_t)v;
      hi[i] = (uint32_t)(v >> 32);
    }
#pragma unroll
    for (int r = 0; r < WIDTH; ++r) {
      uint64_t sum_lo = 0, sum_hi = 0;
#pragma unroll
      for (int i = 0; i < WIDTH; ++i) {
        sum_lo += (uint64_t)lo[i] * mds_entry(r, i);
        sum_hi += (uint64_t)hi[i] * mds_entry(r, i);
      }
      const uint64_t lo64 = sum_lo + (sum_hi << 32);
      out[r * m + j] = reduce128(lo64, (sum_hi >> 32) + (lo64 < sum_lo ? 1ull : 0ull));
    }
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

// One side of a tile of L lanes of k words: an operand's (or the
// output's) words of lane l at off[l] + j * axis, and shared memory
// t[l * k + j].  A block walks the tile's L k words so that neighbouring
// threads touch neighbouring addresses: lane by lane along the words
// where a lane's words are contiguous, else word by word across the
// lanes.  Element e of the walk is word j of lane l:
// (e / k by a multiply: exact while e k < 2^32.)
__device__ __forceinline__ void tile_pos(int e, long long axis, int L, int log_l, int k, int& l,
                                         int& j) {
  const unsigned long long recip = 0xFFFFFFFFull / (unsigned)k + 1;  // ceil(2^32 / k)
  l = axis == 1 ? (int)(((unsigned long long)(unsigned)e * recip) >> 32) : e & (L - 1);
  j = axis == 1 ? e - l * k : e >> log_l;
}

__device__ __forceinline__ void tile_load(const uint64_t* __restrict__ src, const long long* off,
                                          long long axis, int L, int log_l, int k, int live,
                                          uint64_t* t) {
  for (int e = threadIdx.x; e < L * k; e += blockDim.x) {
    int l, j;
    tile_pos(e, axis, L, log_l, k, l, j);
    if (l < live) t[l * k + j] = src[off[l] + j * axis];
  }
}

__device__ __forceinline__ void tile_store(uint64_t* __restrict__ dst, const long long* off,
                                           long long axis, int L, int log_l, int k, int live,
                                           const uint64_t* t) {
  for (int e = threadIdx.x; e < L * k; e += blockDim.x) {
    int l, j;
    tile_pos(e, axis, L, log_l, k, l, j);
    if (l < live) dst[off[l] + j * axis] = t[l * k + j];
  }
}

// batch_inverse_axis (DIV false) and batch_divide_axis (out = num /
// a along the lane), a group of G = 2^log_g threads a lane and L =
// blockDim.x / G lanes a block.  A lane is the k words a[lane + j *
// a_axis] (num's at n_axis, the outputs' at o_axis), k <= G *
// BATCH_WORDS.  Thread t of a group holds the words j = t + r G in
// registers: the product of those before each (lp) and of all (q_t);
// the words themselves stay in the tile.  Two scans of the group's q in shared memory, a prefix and a
// suffix at once, give each thread the product of the other threads'
// words and the lane's total; thread l of the block inverts lane l's
// total (one Fermat a lane); thread t's inverse of q_t is then that inverse
// times the other threads' product, and its words' inverses come from it
// by back-substitution.  The products in between are weak (exact mod p);
// every output is the canonical value of an exact product, so it is the
// plain version's word; a zero in a lane zeroes that lane's total,
// inverse and outputs, and no other lane's.
// Shared memory: the tile's lane offsets, the a tile (overwritten by the
// outputs), num's tile, the two scans and the lanes' inverses.
template <bool DIV>
__global__ void __launch_bounds__(BATCH_THREADS, BATCH_MIN_BLOCKS)
    batch_inverse_kernel(const uint64_t* __restrict__ a, Strides sa, long long a_axis,
                         const uint64_t* __restrict__ num, Strides sn, long long n_axis, Dims d,
                         long long lanes, Strides so, long long o_axis, int k, int log_g,
                         uint64_t* __restrict__ out) {
  extern __shared__ uint64_t smem[];
  const int G = 1 << log_g, T = blockDim.x, L = T >> log_g;
  int log_l = 0;
  while ((1 << log_l) < L) ++log_l;
  long long* off = reinterpret_cast<long long*>(smem);  // [3][L]: a, num, out
  uint64_t* xt = smem + 3 * L;                          // [L][k]
  uint64_t* nt = xt + L * k;                            // [L][k] (DIV)
  uint64_t* pre = nt + (DIV ? L * k : 0);               // [T]
  uint64_t* suf = pre + T;                              // [T]
  uint64_t* invs = suf + T;                             // [L]
  const int tid = threadIdx.x, l = tid >> log_g, t = tid & (G - 1);
  const int row = l * k;
  for (long long lane0 = (long long)blockIdx.x * L; lane0 < lanes;
       lane0 += (long long)gridDim.x * L) {
    const int live = lanes - lane0 < L ? (int)(lanes - lane0) : L;
    if (tid < live) {
      offsets(d, sa, so, lane0 + tid, off[tid], off[2 * L + tid]);
      long long unused;
      if (DIV) offsets(d, sn, sn, lane0 + tid, off[L + tid], unused);
    }
    __syncthreads();
    tile_load(a, off, a_axis, L, log_l, k, live, xt);
    if (DIV) tile_load(num, off + L, n_axis, L, log_l, k, live, nt);
    __syncthreads();
    uint64_t lp[BATCH_WORDS], q = 1;
#pragma unroll
    for (int r = 0; r < BATCH_WORDS; ++r) {
      const int j = t + (r << log_g);
      if (j < k) {
        lp[r] = q;
        q = gl::mul_weak(q, xt[row + j]);
      }
    }
    // inclusive prefix (pre) and suffix (suf) products of the group's q
    uint64_t ip = q, is = q;
    pre[tid] = q;
    suf[tid] = q;
    for (int s = 1; s < G; s <<= 1) {
      __syncthreads();
      const uint64_t p = t >= s ? pre[tid - s] : 1;
      const uint64_t f = t + s < G ? suf[tid + s] : 1;
      __syncthreads();
      if (t >= s) pre[tid] = ip = gl::mul_weak(ip, p);
      if (t + s < G) suf[tid] = is = gl::mul_weak(is, f);
    }
    __syncthreads();
    const uint64_t before = t ? pre[tid - 1] : 1, after = t + 1 < G ? suf[tid + 1] : 1;
    // the lanes' totals, inverted by the block's first L threads, so that
    // one warp issues the chain for 32 lanes instead of each warp for its
    // own few
    if (tid < L) invs[tid] = inverse(pre[tid * G + G - 1]);
    const uint64_t others = gl::mul_weak(before, after);
    __syncthreads();
    uint64_t w = gl::mul_weak(invs[l], others);  // the inverse of q
#pragma unroll
    for (int r = BATCH_WORDS - 1; r >= 0; --r) {
      const int j = t + (r << log_g);
      if (j < k) {
        const uint64_t x = xt[row + j];
        uint64_t o = gl::mul_weak(w, lp[r]);
        if (DIV) o = gl::mul_weak(o, nt[row + j]);
        xt[row + j] = gl::canonical(o);
        w = gl::mul_weak(w, x);
      }
    }
    __syncthreads();
    tile_store(out, off + 2 * L, o_axis, L, log_l, k, live, xt);
    __syncthreads();  // the tile and the offsets are read before the next tile writes them
  }
}

// ---- K6 ---------------------------------------------------------------------

// The bases of one powers launch, base z at p[z] (its second word, for
// an extension base, at p[z] + c[z]); passed by value, so that a launch
// captured in a CUDA graph keeps them.
struct Bases {
  const uint64_t* p[MAX_BASES];
  long long c[MAX_BASES];
};

// Field or extension element in registers, weakly (any words congruent
// to its value).
template <bool EXT>
struct Elem {
  uint64_t v0, v1;
};

template <bool EXT>
__device__ __forceinline__ Elem<EXT> elem_mul(Elem<EXT> a, Elem<EXT> b) {
  Elem<EXT> r{0, 0};
  if (EXT) ext_mul_weak(a.v0, a.v1, b.v0, b.v1, r.v0, r.v1);
  else r.v0 = gl::mul_weak(a.v0, b.v0);
  return r;
}

template <bool EXT>
__device__ __forceinline__ Elem<EXT> tab_get(const uint64_t* t, int i) {
  return EXT ? Elem<EXT>{t[2 * i], t[2 * i + 1]} : Elem<EXT>{t[i], 0};
}

template <bool EXT>
__device__ __forceinline__ void tab_set(uint64_t* t, int i, Elem<EXT> e) {
  if (EXT) {
    t[2 * i] = e.v0;
    t[2 * i + 1] = e.v1;
  } else {
    t[i] = e.v0;
  }
}

// tab[j] = cur^j for j < 2^steps, by the plain version's doubling steps
// (tab[0] = 1 set before): step s fills [2^s, 2^(s+1)) from [0, 2^s),
// one multiply a thread and a barrier.  Returns cur^(2^steps).
template <bool EXT>
__device__ __forceinline__ Elem<EXT> doubling(uint64_t* tab, int steps, Elem<EXT> cur) {
  for (int s = 0; s < steps; ++s) {
    __syncthreads();
    for (int j = (1 << s) + threadIdx.x; j < (2 << s); j += blockDim.x)
      tab_set<EXT>(tab, j, elem_mul<EXT>(tab_get<EXT>(tab, j - (1 << s)), cur));
    cur = elem_mul<EXT>(cur, cur);
  }
  return cur;
}

// out[z][i] = b_z^i for i < n, base z = blockIdx.y.  Each block builds two
// tables in shared memory, T[j] = b^j (j < 2^s) and U[q] = (b^(2^s))^q (q
// < 2^u, 2^(s+u) >= n), then writes its outputs as T[i mod 2^s] U[i >>
// s], one multiply each: a chain of s + u + 1 dependent multiplies
// instead of square and multiply's 2 log2(n).  The tables are weak; each
// output is the canonical value of an exact product, which is the plain
// version's word whatever the grouping; b^0 is 1 (1 + 0x) as there.
template <bool EXT>
__global__ void __launch_bounds__(POW_THREADS)
    field_powers_kernel(Bases bs, long long n, int s, int u, uint64_t* __restrict__ out) {
  extern __shared__ uint64_t tabs[];
  constexpr int W = EXT ? 2 : 1;
  uint64_t* tt = tabs;
  uint64_t* ut = tabs + (W << s);
  const int z = blockIdx.y;
  const uint64_t* b = bs.p[z];
  if (threadIdx.x == 0) {
    tab_set<EXT>(tt, 0, Elem<EXT>{1, 0});
    tab_set<EXT>(ut, 0, Elem<EXT>{1, 0});
  }
  const Elem<EXT> c = doubling<EXT>(tt, s, Elem<EXT>{b[0], EXT ? b[bs.c[z]] : 0});
  doubling<EXT>(ut, u, c);
  __syncthreads();
  uint64_t* o = out + (long long)z * n * W;
  for (long long i = first_index(); i < n; i += grid_step()) {
    const Elem<EXT> e = elem_mul<EXT>(tab_get<EXT>(tt, (int)(i & ((1 << s) - 1))),
                                      tab_get<EXT>(ut, (int)(i >> s)));
    tab_set<EXT>(o + i * W, 0, Elem<EXT>{gl::canonical(e.v0), gl::canonical(e.v1)});
  }
}

// ---- K7 ---------------------------------------------------------------------

// The lane's term i: x[i * st], or with a weight (dot_mod) its product by
// w[i * wst].
template <bool W>
__device__ __forceinline__ uint64_t term(const uint64_t* x, long long st, const uint64_t* w,
                                         long long wst, long long i) {
  return W ? gl::mul(x[i * st], w[i * wst]) : x[i * st];
}

// One halving step of the plain sum_mod at index i < h = n / 2 over the
// terms: t[i] + t[i + h], plus t[n - 1] at i = 0 when n is odd.
template <bool W>
__device__ __forceinline__ uint64_t halve_at(const uint64_t* x, long long st, const uint64_t* w,
                                             long long wst, long long i, long long h,
                                             long long n) {
  uint64_t v = gl::add(term<W>(x, st, w, wst, i), term<W>(x, st, w, wst, i + h));
  if (i == 0 && (n & 1)) v = gl::add(v, term<W>(x, st, w, wst, n - 1));
  return v;
}

// The first halving of a lane's n terms into s[i * ss] for i = i0, i0 +
// step, ... below n / 2, four at a time, so that their loads are in
// flight together.
template <bool W>
__device__ __forceinline__ void first_halving(const uint64_t* x, long long st, const uint64_t* w,
                                              long long wst, long long n, long long i0,
                                              long long step, uint64_t* s, long long ss) {
  const long long m = n / 2;
  long long i = i0;
  for (; i + 3 * step < m; i += 4 * step) {
    uint64_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = halve_at<W>(x, st, w, wst, i + u * step, m, n);
#pragma unroll
    for (int u = 0; u < 4; ++u) s[(i + u * step) * ss] = v[u];
  }
  for (; i < m; i += step) s[i * ss] = halve_at<W>(x, st, w, wst, i, m, n);
}

// One halving of every lane into out: the first steps of a sum too long
// for one block's shared memory.  Row-major (lanes, n / 2) for the
// one-block-a-lane sum; axis-major (n / 2, lanes) for the tiled one, so
// that its next step reads neighbouring lanes at neighbouring words.
template <bool W>
__global__ void __launch_bounds__(MAP_THREADS)
    sum_halve_kernel(const uint64_t* __restrict__ a, Strides sa, long long a_axis,
                     const uint64_t* __restrict__ w, Strides sw, long long w_axis, Dims d,
                     long long lanes, long long n, bool axis_major,
                     uint64_t* __restrict__ out) {
  const long long h = n / 2;
  for (long long idx = first_index(); idx < lanes * h; idx += grid_step()) {
    const long long lane = axis_major ? idx % lanes : idx / h;
    const long long i = axis_major ? idx / lanes : idx - lane * h;
    long long ia, iw;
    offsets(d, sa, sw, lane, ia, iw);
    out[idx] = halve_at<W>(a + ia, a_axis, w + iw, w_axis, i, h, n);
  }
}

// One block a lane: the first halving from device memory into shared
// memory, then every later one in place (a step writes words below h and
// reads only its own word there), a barrier between steps.
template <bool W>
__global__ void __launch_bounds__(MAP_THREADS)
    sum_block_kernel(const uint64_t* __restrict__ a, Strides sa, long long a_axis,
                     const uint64_t* __restrict__ w, Strides sw, long long w_axis, Dims d,
                     long long lanes, long long n, uint64_t* __restrict__ out) {
  extern __shared__ uint64_t s[];
  const long long t = threadIdx.x, T = blockDim.x;
  for (long long lane = blockIdx.x; lane < lanes; lane += gridDim.x) {
    long long ia, iw;
    offsets(d, sa, sw, lane, ia, iw);
    const uint64_t *x = a + ia, *wl = w + iw;
    if (n < 2) {  // the plain version: zeros for n = 0, term 0 for n = 1
      if (t == 0) out[lane] = n ? term<W>(x, a_axis, wl, w_axis, 0) : 0;
      continue;
    }
    const long long m = n / 2;
    first_halving<W>(x, a_axis, wl, w_axis, n, t, T, s, 1);
    for (long long len = m; len > 1; len /= 2) {
      __syncthreads();
      const long long h = len / 2;
      for (long long i = t; i < h; i += T) s[i] = halve_at<false>(s, 1, s, 0, i, h, len);
    }
    __syncthreads();
    if (t == 0) out[lane] = s[0];
    __syncthreads();  // s[0] is read before the next lane writes it
  }
}

// One block a tile of SUM_TILE neighbouring lanes: thread t takes lane
// t % SUM_TILE of the tile and the rows t / SUM_TILE + k * R (R warps),
// so that a warp reads SUM_TILE neighbouring lanes of one row.  The first
// halving goes from device memory into shared memory s[row][lane], every
// later one in place as in sum_block_kernel.  Lanes past the last are
// computed on garbage and never written.
template <bool W>
__global__ void __launch_bounds__(MAP_THREADS)
    sum_tile_kernel(const uint64_t* __restrict__ a, Strides sa, long long a_axis,
                    const uint64_t* __restrict__ w, Strides sw, long long w_axis, Dims d,
                    long long lanes, long long n, uint64_t* __restrict__ out) {
  extern __shared__ uint64_t s[];
  const int l = threadIdx.x % SUM_TILE;
  const long long r0 = threadIdx.x / SUM_TILE, R = blockDim.x / SUM_TILE;
  uint64_t* col = s + l;
  for (long long t0 = (long long)blockIdx.x * SUM_TILE; t0 < lanes;
       t0 += (long long)gridDim.x * SUM_TILE) {
    const long long lane = t0 + l;
    const bool live = lane < lanes;
    long long ia = 0, iw = 0;
    if (live) offsets(d, sa, sw, lane, ia, iw);
    const uint64_t *x = a + ia, *wl = w + iw;
    if (n < 2) {
      if (r0 == 0 && live) out[lane] = n ? term<W>(x, a_axis, wl, w_axis, 0) : 0;
      continue;
    }
    const long long m = n / 2;
    if (live) first_halving<W>(x, a_axis, wl, w_axis, n, r0, R, col, SUM_TILE);
    for (long long len = m; len > 1; len /= 2) {
      __syncthreads();
      const long long h = len / 2;
      for (long long i = r0; i < h; i += R)
        col[i * SUM_TILE] = halve_at<false>(col, SUM_TILE, col, 0, i, h, len);
    }
    __syncthreads();
    if (r0 == 0 && live) out[lane] = col[0];
    __syncthreads();  // row 0 is read before the next tile writes it
  }
}

// prod_chunks: output i of the contiguous (d) index space is the product
// of run k of the input's words along the axis (dim `axis` of d, k its
// coordinate there): words k * chunk .. min((k + 1) * chunk, n) - 1 at
// a_axis apart, from the offset that sa gives i (its axis stride is
// a_axis * chunk).  A run of one word is that word, as in the plain
// version; a longer run's product is canonical in any order.
__global__ void __launch_bounds__(MAP_THREADS)
    prod_chunks_kernel(const uint64_t* __restrict__ a, Strides sa, Dims d, int axis,
                       long long a_axis, long long n, long long chunk, long long total,
                       uint64_t* __restrict__ out) {
  for (long long i = first_index(); i < total; i += grid_step()) {
    long long rest = i, oa = 0, k = 0;
#pragma unroll
    for (int dim = MAX_DIMS - 1; dim >= 0; --dim) {
      if (dim >= d.nd) continue;
      const long long q = dim ? rest / d.n[dim] : 0;
      const long long r = dim ? rest - q * d.n[dim] : rest;
      if (dim == axis) k = r;
      oa += r * sa.s[dim];
      rest = q;
    }
    const long long len = n - k * chunk < chunk ? n - k * chunk : chunk;
    const uint64_t* x = a + oa;
    uint64_t acc = x[0];
    for (long long j = 1; j < len; ++j) acc = gl::mul(acc, x[j * a_axis]);
    out[i] = acc;
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

// The current device's SM count, read once a device.
int sm_count() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] <= 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = v > 0 ? v : 132;
  }
  return cached[dev];
}

template <int OP>
int launch_map(const uint64_t* a, Strides sa, long long ca, const uint64_t* b, Strides sb,
               long long cb, uint64_t c, Dims d, long long n, uint64_t* out,
               cudaStream_t stream) {
  const unsigned blocks = blocks_for(n, MAP_THREADS);
  field_map_kernel<OP><<<blocks, MAP_THREADS, 0, stream>>>(a, sa, ca, b, sb, cb, c, d, n, out);
  return (int)cudaGetLastError();
}

// The fast path's layout of a map over nd <= 2 dims, if it has one: one
// flat dim whose strides are 0 or 1 is a row (vectorisable); a flat dim
// at other strides is a column of rows; two dims need column strides of
// 0 or 1.  Every offset must fit 31 bits.  vec: 16-byte accesses hold
// (the output's and each stepping operand's rows start 16-byte aligned).
bool fast_layout(int nd, const long long* shape, const long long* sa, const long long* sb,
                 const void* a, const void* b, const void* out, Fast2& f, bool& vec) {
  long long rows, cols, ra, rb, ca, cb;
  if (nd == 1 && (sa[0] == 0 || sa[0] == 1) && (sb[0] == 0 || sb[0] == 1)) {
    rows = 1, cols = shape[0], ra = rb = 0, ca = sa[0], cb = sb[0];
  } else if (nd == 1) {
    rows = shape[0], cols = 1, ra = sa[0], rb = sb[0], ca = cb = 0;
  } else if (nd == 2 && (sa[1] == 0 || sa[1] == 1) && (sb[1] == 0 || sb[1] == 1)) {
    rows = shape[0], cols = shape[1], ra = sa[0], rb = sb[0], ca = sa[1], cb = sb[1];
  } else {
    return false;
  }
  const long long lim = 1LL << 31;
  if (rows < 1 || cols < 1 || ra < 0 || rb < 0 || rows * cols >= lim ||
      (rows - 1) * ra + (cols - 1) * ca >= lim || (rows - 1) * rb + (cols - 1) * cb >= lim)
    return false;
  f.rows = (unsigned)rows, f.cols = (unsigned)cols;
  f.ra = (unsigned)ra, f.rb = (unsigned)rb, f.ca = (unsigned)ca, f.cb = (unsigned)cb;
  auto aligned = [&](const void* p, long long c, long long r) {
    return !c || ((uintptr_t)p % 16 == 0 && (rows == 1 || r % 2 == 0));
  };
  vec = cols >= 2 && (rows == 1 || cols % 2 == 0) && (uintptr_t)out % 16 == 0 &&
        aligned(a, ca, ra) && aligned(b, cb, rb);
  const long long units = vec ? (cols + 1) / 2 : cols;  // a thread's share of a row
  int log_tpr = 0;
  while ((1LL << log_tpr) < units && (1 << log_tpr) < MAP_THREADS) ++log_tpr;
  f.log_tpr = log_tpr;
  return true;
}

template <int OP>
int launch_fast(const uint64_t* a, const uint64_t* b, uint64_t c, const Fast2& f, bool vec,
                uint64_t* out, cudaStream_t stream) {
  const long long tpr = 1LL << f.log_tpr, rpb = MAP_THREADS / tpr;
  const long long units = vec ? (f.cols + 1) / 2 : f.cols;
  const long long cap = (long long)sm_count() * MAP_BLOCKS_PER_SM;
  long long gx = (units + tpr - 1) / tpr, gy = (f.rows + rpb - 1) / rpb;
  gx = gx < cap ? gx : cap;
  const long long ycap = cap / gx > 1 ? cap / gx : 1;
  gy = gy < ycap ? gy : ycap;
  gy = gy < 65535 ? gy : 65535;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  if (vec)
    field_map_fast_kernel<OP, 2><<<grid, MAP_THREADS, 0, stream>>>(a, b, c, f, out);
  else
    field_map_fast_kernel<OP, 1><<<grid, MAP_THREADS, 0, stream>>>(a, b, c, f, out);
  return (int)cudaGetLastError();
}

template <int OP>
int map_op(const uint64_t* a, const long long* sa, long long ca, const uint64_t* b,
           const long long* sb, long long cb, uint64_t c, int nd, const long long* shape,
           uint64_t* out, cudaStream_t s) {
  Dims d;
  long long n;
  if (!make_dims(nd, shape, d, n)) return (int)cudaErrorInvalidValue;
  Fast2 f;
  bool vec;
  if (OP != EXT_MUL && fast_layout(nd, shape, sa, sb, a, b, out, f, vec))
    return launch_fast<OP>(a, b, c, f, vec, out, s);
  return launch_map<OP>(a, make_strides(nd, sa), ca, b, make_strides(nd, sb), cb, c, d, n, out,
                        s);
}

// sum_mod's layout: a tile of SUM_TILE lanes a block where a lane's
// words are not contiguous and there are lanes to tile, else one block a
// lane; and the longest lane whose first halving fits the block's shared
// memory.
bool sum_tiled(long long lanes, long long a_axis) { return a_axis != 1 && lanes > 1; }

long long sum_block_words(bool tiled) {
  return tiled ? 2 * SUM_SMEM_WORDS / SUM_TILE : 2 * SUM_SMEM_WORDS;
}

template <bool W>
int launch_sum(const uint64_t* a, Strides sa, long long a_axis, const uint64_t* w, Strides sw,
               long long w_axis, Dims d, long long lanes, long long n, bool tiled,
               uint64_t* out, cudaStream_t s) {
  if (tiled) {
    const long long tiles = (lanes + SUM_TILE - 1) / SUM_TILE;
    long long threads = SUM_TILE;  // a warp a row, up to MAP_THREADS
    while (threads < MAP_THREADS && threads / SUM_TILE < n / 2) threads *= 2;
    sum_tile_kernel<W><<<lane_blocks(tiles), (unsigned)threads, (size_t)(n / 2) * SUM_TILE * 8,
                         s>>>(a, sa, a_axis, w, sw, w_axis, d, lanes, n, out);
  } else {
    int threads = 32;
    while (threads < MAP_THREADS && threads < n / 2) threads *= 2;
    sum_block_kernel<W><<<lane_blocks(lanes), threads, (size_t)(n / 2) * 8, s>>>(
        a, sa, a_axis, w, sw, w_axis, d, lanes, n, out);
  }
  return (int)cudaGetLastError();
}

template <bool W>
int launch_halve(const uint64_t* a, Strides sa, long long a_axis, const uint64_t* w, Strides sw,
                 long long w_axis, Dims d, long long lanes, long long n, bool tiled,
                 uint64_t* out, cudaStream_t s) {
  sum_halve_kernel<W><<<blocks_for(lanes * (n / 2), MAP_THREADS), MAP_THREADS, 0, s>>>(
      a, sa, a_axis, w, sw, w_axis, d, lanes, n, tiled, out);
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
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case ADD: return map_op<ADD>(a, sa, ca, b, sb, cb, c, nd, shape, out, s);
    case SUB: return map_op<SUB>(a, sa, ca, b, sb, cb, c, nd, shape, out, s);
    case NEG: return map_op<NEG>(a, sa, ca, a, sa, cb, c, nd, shape, out, s);
    case MUL: return map_op<MUL>(a, sa, ca, b, sb, cb, c, nd, shape, out, s);
    case SQUARE: return map_op<SQUARE>(a, sa, ca, a, sa, cb, c, nd, shape, out, s);
    case MUL_SMALL: return map_op<MUL_SMALL>(a, sa, ca, a, sa, cb, c, nd, shape, out, s);
    case REDUCE128: return map_op<REDUCE128>(a, sa, ca, b, sb, cb, c, nd, shape, out, s);
    case EXT_MUL: return map_op<EXT_MUL>(a, sa, ca, b, sb, cb, c, nd, shape, out, s);
    case POW7: return map_op<POW7>(a, sa, ca, a, sa, cb, c, nd, shape, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4's path for qzk_field_map's op over `shape` at strides sa and sb: 0
// the general one, 1 the fast one a word a thread, 2 the fast one with
// 16-byte accesses.
int qzk_map_path(int op, int nd, const long long* shape, const long long* sa,
                 const long long* sb, const void* a, const void* b, const void* out) {
  Dims d;
  long long n;
  Fast2 f;
  bool vec;
  if (op == EXT_MUL || !make_dims(nd, shape, d, n) ||
      !fast_layout(nd, shape, sa, sb, a, b, out, f, vec))
    return 0;
  return vec ? 2 : 1;
}

// K4, the Poseidon gate's round over a (12, m) state: out (12, m,
// contiguous) = mds(x^7) with full set, else mds of (x0^7, x[1..11]); x
// at row stride xr and column stride xc, x0 at x0c.
int qzk_mds(int full, const uint64_t* x, long long xr, long long xc, const uint64_t* x0,
            long long x0c, long long m, uint64_t* out, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = blocks_for(m, MAP_THREADS);
  const cudaStream_t s = (cudaStream_t)stream;
  if (full)
    mds_kernel<true><<<blocks, MAP_THREADS, 0, s>>>(x, xr, xc, x0, x0c, m, out);
  else
    mds_kernel<false><<<blocks, MAP_THREADS, 0, s>>>(x, xr, xc, x0, x0c, m, out);
  return (int)cudaGetLastError();
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

// K5, batch_inverse_axis: the log2 of the threads a lane (G) that
// qzk_batch_inverse takes by default for lanes of k words, 1 <= k <=
// BATCH_THREADS * BATCH_WORDS; -1 past that.
int qzk_batch_group(long long k) {
  if (k < 1 || k > (long long)BATCH_THREADS * BATCH_WORDS) return -1;
  int log_g = 0;
  while ((long long)BATCH_WORDS << log_g < k) ++log_g;
  return log_g;
}

// K5, batch_inverse_axis (num null) and batch_divide_axis (out = num
// times the batch inverse of a): lanes over `shape` at strides sa (a), sn
// (num) and so (the output), k words a lane at a_axis, n_axis and o_axis;
// G = 2^log_g threads a lane (G <= BATCH_THREADS, k <= G * BATCH_WORDS).
int qzk_batch_inverse(const uint64_t* a, const long long* sa, long long a_axis,
                      const uint64_t* num, const long long* sn, long long n_axis, int nd,
                      const long long* shape, const long long* so, long long o_axis, long long k,
                      int log_g, uint64_t* out, void* stream) {
  Dims d;
  long long lanes;
  if (!make_dims(nd, shape, d, lanes) || log_g < 0 || (1 << log_g) > BATCH_THREADS || k < 1 ||
      k > ((long long)BATCH_WORDS << log_g))
    return (int)cudaErrorInvalidValue;
  const int threads = BATCH_THREADS, L = threads >> log_g;
  const bool div = num != nullptr;
  // at most 32 KB: L k <= BATCH_THREADS * BATCH_WORDS
  const size_t words = 4 * (size_t)L + (div ? 2 : 1) * (size_t)L * k + 2 * (size_t)threads;
  const unsigned blocks = blocks_for(lanes, L);
  const cudaStream_t s = (cudaStream_t)stream;
  const Strides A = make_strides(nd, sa), O = make_strides(nd, so);
  if (div)
    batch_inverse_kernel<true><<<blocks, threads, words * 8, s>>>(
        a, A, a_axis, num, make_strides(nd, sn), n_axis, d, lanes, O, o_axis, (int)k, log_g,
        out);
  else
    batch_inverse_kernel<false><<<blocks, threads, words * 8, s>>>(
        a, A, a_axis, a, A, 0, d, lanes, O, o_axis, (int)k, log_g, out);
  return (int)cudaGetLastError();
}

// K6: the table sizes of a launch for n >= 1 powers: s (log2 of T's
// entries) and u (of U's), s + u = ceil(log2 n), s - u in {0, 1}; returns
// -1 above 2^POW_MAX_LOG_N.
int qzk_powers_tables(long long n, int* u) {
  int log_n = 0;
  while ((1LL << log_n) < n) ++log_n;
  if (n < 1 || log_n > POW_MAX_LOG_N) return -1;
  *u = log_n / 2;
  return log_n - *u;
}

// K6: out[z][i] = b_z^i for i < n and z < count (count <= MAX_BASES), b_z
// the word at bases[z]; with ext set, the extension powers of (bases[z][0],
// bases[z][comps[z]]) into out[z]'s pairs.
int qzk_field_powers(int ext, int count, const uint64_t* const* bases, const long long* comps,
                     long long n, uint64_t* out, void* stream) {
  int u = 0;
  const int s = qzk_powers_tables(n, &u);
  if (s < 0 || count < 1 || count > MAX_BASES) return (int)cudaErrorInvalidValue;
  Bases bs;
  for (int z = 0; z < MAX_BASES; ++z) {
    bs.p[z] = z < count ? bases[z] : nullptr;
    bs.c[z] = z < count && comps != nullptr ? comps[z] : 0;
  }
  const size_t bytes = (size_t)((1LL << s) + (1LL << u)) * (ext ? 16 : 8);
  long long gx = (n + POW_THREADS - 1) / POW_THREADS;
  const long long cap = 2LL * sm_count() / count > 1 ? 2LL * sm_count() / count : 1;
  gx = gx < cap ? gx : cap;
  const dim3 grid((unsigned)gx, (unsigned)count);
  const cudaStream_t st = (cudaStream_t)stream;
  if (ext) {
    if (bytes > 48 * 1024)
      cudaFuncSetAttribute(field_powers_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    field_powers_kernel<true><<<grid, POW_THREADS, bytes, st>>>(bs, n, s, u, out);
  } else {
    if (bytes > 48 * 1024)
      cudaFuncSetAttribute(field_powers_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    field_powers_kernel<false><<<grid, POW_THREADS, bytes, st>>>(bs, n, s, u, out);
  }
  return (int)cudaGetLastError();
}

// K7, sum_mod and dot_mod: the halvings before the block sum of `lanes`
// lanes of n words, a lane's words a_axis apart, and the scratch words
// they take.  A lane longer than one block's shared memory takes (2 *
// SUM_SMEM_WORDS words a lane, or 2 * SUM_SMEM_WORDS / SUM_TILE when
// tiled) is halved into scratch, one launch a halving, alternating
// between two regions (lanes * (n / 2) words, then lanes * (n / 4)),
// until it fits.  Returns the launches of one qzk_sum_mod call.
int qzk_sum_plan(long long lanes, long long n, long long a_axis, long long* scratch_words) {
  const long long fits = sum_block_words(sum_tiled(lanes, a_axis));
  long long halvings = 0, words = 0;
  for (long long m = n; m > fits; m /= 2, ++halvings)
    if (halvings < 2) words += lanes * (m / 2);
  *scratch_words = words;
  return (int)(halvings + 1);
}

// K7, sum_mod (w null) and dot_mod: out[lane] = the plain sum_mod of the
// lane's n terms, a[lane + i * a_axis], times w[lane' + i * w_axis] for
// dot_mod; the lanes over `shape` at strides sa (and sw); scratch:
// qzk_sum_plan's words (unused, and may be null, when it asks for none).
int qzk_sum_mod(const uint64_t* a, const long long* sa, long long a_axis, const uint64_t* w,
                const long long* sw, long long w_axis, int nd, const long long* shape,
                long long n, uint64_t* scratch, uint64_t* out, void* stream) {
  Dims d;
  long long lanes;
  if (!make_dims(nd, shape, d, lanes) || n < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool tiled = sum_tiled(lanes, a_axis);
  const long long fits = sum_block_words(tiled);
  Strides st = make_strides(nd, sa), wt = make_strides(nd, sw);
  uint64_t* region[2] = {scratch, scratch};
  for (long long m = n, k = 0; m > fits; m /= 2, ++k) {
    if (k == 0) region[1] = scratch + lanes * (m / 2);
    uint64_t* half = region[k & 1];
    const int err = w != nullptr && k == 0
                        ? launch_halve<true>(a, st, a_axis, w, wt, w_axis, d, lanes, m, tiled,
                                             half, s)
                        : launch_halve<false>(a, st, a_axis, a, st, 0, d, lanes, m, tiled, half,
                                              s);
    if (err != cudaSuccess) return err;
    // The next step reads the half as (lanes, m / 2) row-major, or as
    // (m / 2, lanes) when tiled, and sums it with no weight.
    const long long one = 1, row = m / 2, count = lanes;
    make_dims(1, &count, d, lanes);
    st = make_strides(1, tiled ? &one : &row);
    a = half, n = row, a_axis = tiled ? lanes : 1, w = nullptr;
  }
  return w != nullptr
             ? launch_sum<true>(a, st, a_axis, w, wt, w_axis, d, lanes, n, tiled, out, s)
             : launch_sum<false>(a, st, a_axis, a, st, 0, d, lanes, n, tiled, out, s);
}

// K7, prod_chunks: out (contiguous, `shape`: the input's shape with dim
// `axis` cut to ceil(n / chunk)) = the product of each run of `chunk`
// words along the axis; sa: the input's strides over `shape`, its axis
// stride a_axis * chunk.
int qzk_prod_chunks(const uint64_t* a, const long long* sa, int nd, const long long* shape,
                    int axis, long long a_axis, long long n, long long chunk, uint64_t* out,
                    void* stream) {
  Dims d;
  long long total;
  if (!make_dims(nd, shape, d, total) || axis < 0 || axis >= nd || chunk < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  prod_chunks_kernel<<<blocks_for(total, MAP_THREADS), MAP_THREADS, 0, (cudaStream_t)stream>>>(
      a, make_strides(nd, sa), d, axis, a_axis, n, chunk, total, out);
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
