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
// What bounds it on this card: instruction issue, then device-memory
// bytes.  A pass moves each element in and out once (and the twiddle
// block in), but each butterfly is about 54 32-bit integer instructions
// on the ALU and FMA pipes (the field product is four 32 x 32 products
// and a reduction); at 2^11 rows their issue alone takes 1.4x the bytes
// bound.  So the design keeps the data in registers, lets shared memory
// serve only as the exchange between groups of stages, and spends its
// registers on occupancy:
//
// - Each thread holds R = 2^K rows of two adjacent columns: K = 2 up to
//   2^10 rows, 3 at 2^11; from 2^12 to 2^14 rows, K = 5: 32 rows of one
//   column (a 2^14-row tile of two columns would not fit the 227 KB of
//   shared memory).  The stages run in groups of K in registers.
//   In group g the thread's rows differ only in a K-bit window of the
//   row index (bits [w, w + K), w = min(gK, log_n - K)); between groups
//   the block writes its rows to shared memory, waits once, and reads
//   the next window's rows.  At 2^11 rows the 11 stages are 3 + 3 + 3 +
//   2: three exchanges and four barriers a tile, in place of twelve
//   barriers and eleven round trips through shared memory; at 2^8 rows
//   2 + 2 + 2 + 2, four barriers in place of nine.
// - The bit-reversed load is the first gather: register j of the thread
//   with index q holds tile row (rev(q) << K) | j, which is source row
//   q + rev_K(j) 2^(log_n - K).  Consecutive q read consecutive rows, so
//   the transposed (row unit-stride) input of the second four-step pass
//   coalesces.  The twiddle-block product is folded into the store.
// - Any stage's twiddle comes from the last row of the stage table:
//   w_s^j = stw[log_n - 1][j << (log_n - s)].
// - Weak words: after its load a tile asks, with one __syncthreads_or,
//   whether any input word is p or more.  If none is, the plain
//   version's words are all canonical, so any exact arithmetic ending in
//   canonical words gives its bits: the stages carry any 64-bit word
//   congruent mod p (mul_weak, add_weak, sub_weak) and the store makes
//   them canonical.  Otherwise, and always at K = 5, the tile runs the
//   plain version's mul, add and sub, which keep some non-canonical
//   words.
// - Two columns a thread: 16-byte global and shared accesses.  The
//   exchange layout XORs a row's slot in its 128-byte line with the
//   row's top bits when fewer than a line's words share it
//   (tests/test_torch_ntt_fast.py counts the bank conflicts of the
//   exchange's accesses).
// - Registers set the occupancy: 62 at K = 2 (eight blocks of 128
//   threads an SM), 80 at K = 3 (__launch_bounds__(256, 3): three of
//   256), 127 at K = 5 (one block of up to 512 threads).  The wrapper (ntt_cuda.py)
//   sizes the tile (up to 128 threads where the rows allow) and the grid
//   from the shape, the block's facts (qzk_ntt_block) and the
//   occupancy; between one and two waves of tiles, one wave of blocks
//   walks them.
//
// The input may be strided: the second four-step pass reads the
// transpose of the first pass's output in place.  The last column tile
// may be ragged.  Outputs equal the plain version's bit for bit on any
// 64-bit input; they are canonical for canonical inputs.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "goldilocks.cuh"

namespace {

// The instantiations: K <= 3 holds two columns a thread and takes up to
// 256 threads at 80 registers, three blocks an SM; K = 5 (2^12 to 2^14
// rows) one column, up to 512 threads.
template <int K>
__host__ __device__ constexpr int log_cols() { return K < 5 ? 1 : 0; }
template <int K>
__host__ __device__ constexpr int max_threads() { return K < 5 ? 256 : 512; }
template <int K>
__host__ __device__ constexpr int min_blocks() { return K < 5 ? 3 : 1; }
constexpr int WIDE_IN = 1;   // row-major input, 16-byte aligned pairs
constexpr int WIDE_OUT = 2;  // output and twiddle block, 16-byte aligned pairs

struct Args {
  const uint64_t* in;
  long long sb, sr, sc;  // input element strides: batch, row, column
  uint64_t* out;         // (B, 2^log_n, M) contiguous
  const uint64_t* stw;   // (log_n, max(1, n/2)) stage table
  const uint64_t* twiddle;  // (2^log_n, M) contiguous, or null
  long long m;
  long long units;  // B * tiles
  long long tiles;  // column tiles of 2^(log_cp + log_cols) columns
  int log_n;
  int log_cp;  // log2 of the threads across a tile's columns
  int flags;   // WIDE_IN | WIDE_OUT
};

__host__ __device__ constexpr int rev_const(int x, int bits) {
  return bits == 0 ? 0 : ((x & 1) << (bits - 1)) | rev_const(x >> 1, bits - 1);
}

__device__ __forceinline__ int rev_bits(int x, int bits) {
  return bits ? (int)(__brev((unsigned)x) >> (32 - bits)) : 0;
}

// The row whose bits outside the K-bit window at w are `o` and inside it j.
template <int K>
__device__ __forceinline__ int window_row(int o, int j, int w) {
  return (o & ((1 << w) - 1)) | (j << w) | ((o >> w) << (w + K));
}

// Index of the word (16 bytes at two columns a thread, 8 at one) of
// (row, p) in the exchange buffer, p the thread's place across the tile.
// 2^c = (words a 128-byte line of banks) / 2^log_cp rows share a line;
// their slot in it is XORed with the row's top c bits (when log_n >= 2c,
// so that the map stays one to one within a line).
struct Layout {
  int log_cp, cmask, sh;
  __device__ Layout(int log_n, int log_cp_, int log_line) : log_cp(log_cp_) {
    const int c = log_cp_ < log_line ? log_line - log_cp_ : 0;
    cmask = (1 << c) - 1;
    sh = c > 0 && log_n >= 2 * c ? log_n - c : 31;
  }
  __device__ __forceinline__ int at(int row, int p) const {
    const int slot = (row ^ (row >> sh)) & cmask;
    return (((row & ~cmask) | slot) << log_cp) + p;
  }
};

// One radix-2 butterfly: the plain version's mul, add and sub (exact on
// any 64-bit words, bit for bit), or with W their weak forms (some word
// congruent mod p), for tiles whose inputs are all canonical.
template <bool W>
__device__ __forceinline__ void butterfly(uint64_t& a, uint64_t& b, uint64_t w) {
  const uint64_t e = a;
  const uint64_t o = W ? gl::mul_weak(b, w) : gl::mul(b, w);
  a = W ? gl::add_weak(e, o) : gl::add(e, o);
  b = W ? gl::sub_weak(e, o) : gl::sub(e, o);
}

// The butterfly by the twiddle w^0 = 1 without a product: mul(b, 1) is
// canonical(b), and a weak product by 1 may return b itself.
template <bool W>
__device__ __forceinline__ void butterfly_one(uint64_t& a, uint64_t& b) {
  const uint64_t e = a;
  const uint64_t o = W ? b : gl::canonical(b);
  a = W ? gl::add_weak(e, o) : gl::add(e, o);
  b = W ? gl::sub_weak(e, o) : gl::sub(e, o);
}

// The stages of the first window (row bits [0, K)): every twiddle index
// is known at compile time.
template <int K, bool W>
__device__ __forceinline__ void first_stages(uint64_t (&v0)[1 << K], uint64_t (&v1)[1 << K],
                                             const uint64_t* tw_last, int log_n) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int sh = log_n - 1 - k;
#pragma unroll
    for (int j = 0; j < (1 << K); ++j) {
      if (j & (1 << k)) continue;
      const int i = j & ((1 << k) - 1);
      if (i == 0) {
        butterfly_one<W>(v0[j], v0[j | (1 << k)]);
        if (log_cols<K>()) butterfly_one<W>(v1[j], v1[j | (1 << k)]);
      } else {
        const uint64_t tw = __ldg(tw_last + ((long long)i << sh));
        butterfly<W>(v0[j], v0[j | (1 << k)], tw);
        if (log_cols<K>()) butterfly<W>(v1[j], v1[j | (1 << k)], tw);
      }
    }
  }
}

// The stages for row bits [lo, w + K) of the window at w, for the thread
// whose bits outside the window are o.
template <int K, bool W>
__device__ __forceinline__ void window_stages(uint64_t (&v0)[1 << K], uint64_t (&v1)[1 << K],
                                              const uint64_t* tw_last, int log_n, int lo, int w,
                                              int o) {
  const int base = o & ((1 << w) - 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int bit = w + k;
    if (bit < lo) continue;
    const int sh = log_n - 1 - bit;
#pragma unroll
    for (int j = 0; j < (1 << K); ++j) {
      if (j & (1 << k)) continue;
      const int i = j & ((1 << k) - 1);
      const uint64_t tw = __ldg(tw_last + ((long long)(base | (i << w)) << sh));
      butterfly<W>(v0[j], v0[j | (1 << k)], tw);
      if (log_cols<K>()) butterfly<W>(v1[j], v1[j | (1 << k)], tw);
    }
  }
}

// Where a thread stands in its block and tile.  v1, the second column,
// is used only at two columns a thread.
struct Thread {
  int p;       // place across the tile's columns
  int q;       // row index: later windows' outside bits
  int o0;      // the first window's outside bits, rev(q)
  int lq;      // bits of q
  long long bi;  // batch entry
  long long c;   // first of the thread's columns
  bool has0, has1;
};

// All stages of one tile after its load, and the store: the stage groups
// exchange through shared memory; the store multiplies by the twiddle
// block when there is one and, on the weak path, makes the words
// canonical.  xch holds 16-byte words at two columns a thread, 8-byte
// words at one.
template <int K, bool W>
__device__ __forceinline__ void transform_tile(uint64_t (&v0)[1 << K], uint64_t (&v1)[1 << K],
                                               const Args& a, const Thread& th,
                                               const Layout& lay, ulonglong2* xch) {
  constexpr int R = 1 << K;
  const int log_n = a.log_n;
  const int n = 1 << log_n;
  const uint64_t* tw_last = a.stw + (long long)(log_n > 0 ? log_n - 1 : 0) * (n > 1 ? n >> 1 : 1);
  first_stages<K, W>(v0, v1, tw_last, log_n);

  // Later windows: exchange through shared memory, then their stages.
  // Window g > 0 takes o = q; the last one's window sits at bit lq.
  int w_prev = 0, o_prev = th.o0;
  for (int lo = K; lo < log_n; lo += K) {
    const int w = lo < th.lq ? lo : th.lq;
    uint64_t* xch1 = reinterpret_cast<uint64_t*>(xch);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (log_cols<K>())
        xch[lay.at(window_row<K>(o_prev, j, w_prev), th.p)] = make_ulonglong2(v0[j], v1[j]);
      else
        xch1[lay.at(window_row<K>(o_prev, j, w_prev), th.p)] = v0[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (log_cols<K>()) {
        const ulonglong2 v = xch[lay.at(window_row<K>(th.q, j, w), th.p)];
        v0[j] = v.x;
        v1[j] = v.y;
      } else {
        v0[j] = xch1[lay.at(window_row<K>(th.q, j, w), th.p)];
      }
    }
    window_stages<K, W>(v0, v1, tw_last, log_n, lo, w, th.q);
    w_prev = w;
    o_prev = th.q;
  }

  // Store, times the twiddle block when there is one.
  uint64_t* dst = a.out + th.bi * ((long long)n * a.m) + th.c;
  const bool wide_out = (a.flags & WIDE_OUT) && th.has1;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long off = (long long)window_row<K>(o_prev, j, w_prev) * a.m;
    uint64_t y0 = v0[j], y1 = v1[j];
    if (a.twiddle != nullptr) {
      const uint64_t* tw = a.twiddle + off + th.c;
      if (wide_out) {
        const ulonglong2 tv = __ldg(reinterpret_cast<const ulonglong2*>(tw));
        y0 = gl::mul(y0, tv.x);
        y1 = gl::mul(y1, tv.y);
      } else {
        if (th.has0) y0 = gl::mul(y0, __ldg(tw));
        if (th.has1) y1 = gl::mul(y1, __ldg(tw + 1));
      }
    } else if (W) {
      y0 = gl::canonical(y0);
      y1 = gl::canonical(y1);
    }
    if (wide_out) {
      *reinterpret_cast<ulonglong2*>(dst + off) = make_ulonglong2(y0, y1);
    } else {
      if (th.has0) dst[off] = y0;
      if (th.has1) dst[off + 1] = y1;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(max_threads<K>(), min_blocks<K>())
    ntt_axis0_kernel(const Args a) {
  constexpr int R = 1 << K;
  extern __shared__ ulonglong2 xch[];
  Thread th;
  th.lq = a.log_n - K;
  th.p = threadIdx.x & ((1 << a.log_cp) - 1);
  th.q = threadIdx.x >> a.log_cp;
  th.o0 = rev_bits(th.q, th.lq);
  constexpr int LC = log_cols<K>();
  const Layout lay(a.log_n, a.log_cp, 4 - LC);
  uint64_t v0[R], v1[R];

  for (long long u = blockIdx.x; u < a.units; u += gridDim.x) {
    th.bi = u / a.tiles;
    th.c = ((u - th.bi * a.tiles) << (a.log_cp + LC)) + (th.p << LC);
    th.has0 = th.c < a.m;
    th.has1 = LC && th.c + 1 < a.m;

    // Load: register j <- source row q + rev_K(j) << lq.
    const uint64_t* src = a.in + th.bi * a.sb + (long long)th.q * a.sr + th.c * a.sc;
    bool noncanonical = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint64_t* x = src + ((long long)rev_const(j, K) << th.lq) * a.sr;
      if ((a.flags & WIDE_IN) && th.has1) {
        const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(x));
        v0[j] = v.x;
        v1[j] = v.y;
      } else {
        v0[j] = th.has0 ? x[0] : 0ull;
        v1[j] = th.has1 ? x[a.sc] : 0ull;
      }
      noncanonical |= (v0[j] >= gl::P) | (v1[j] >= gl::P);
    }
    // One barrier a tile decides the path for the whole tile and keeps
    // its first exchange write behind the last tile's reads.  K = 5 takes
    // the plain path only: its weak path would spill.
    if (__syncthreads_or(noncanonical) || K == 5)
      transform_tile<K, false>(v0, v1, a, th, lay, xch);
    else
      transform_tile<K, true>(v0, v1, a, th, lay, xch);
  }
}

// The block of a launch plan: its threads, shared bytes (the tile, when
// there is an exchange between stage groups), and columns a tile.
struct Block {
  int threads;
  long long smem;
  long long cols;
};

template <int K>
Block block(int log_n, int log_cp) {
  Block b;
  b.threads = (1 << log_cp) << (log_n - K);
  b.smem = log_n > K ? ((8ll << log_cols<K>()) << log_n) << log_cp : 0;
  b.cols = 1ll << (log_cp + log_cols<K>());
  return b;
}

template <int K>
int launch(Args a, long long b, int grid, void* stream) {
  const Block blk = block<K>(a.log_n, a.log_cp);
  a.tiles = (a.m + blk.cols - 1) / blk.cols;
  a.units = b * a.tiles;
  ntt_axis0_kernel<K><<<grid, blk.threads, blk.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K>
int set_max_smem(int bytes) {
  return (int)cudaFuncSetAttribute(ntt_axis0_kernel<K>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int K>
int blocks_per_sm(int threads, size_t smem, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ntt_axis0_kernel<K>,
                                                            threads, smem);
}

// f(std::integral_constant<int, K>) for the instantiation K = log_r.
template <class F>
int dispatch(int log_r, F f) {
  switch (log_r) {
    case 0: return f(std::integral_constant<int, 0>());
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 5: return f(std::integral_constant<int, 5>());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Lets every instantiation take up to the device's opt-in shared memory
// a block (227 KB on an H100) on the current device; returns that size
// in *max_bytes and the SM count in *sms.  Call once per device before
// any launch.
int qzk_ntt_init(int* max_bytes, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  for (int k : {0, 1, 2, 3, 5}) {
    const int err =
        dispatch(k, [&](auto K) { return set_max_smem<decltype(K)::value>(*max_bytes); });
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

// The block of the plan (log_n, log_r, log_cp): its threads, the most
// the instantiation log_r takes, its shared bytes and its columns a tile.
int qzk_ntt_block(int log_n, int log_r, int log_cp, int* threads, int* max_threads_,
                  long long* smem, long long* cols) {
  return dispatch(log_r, [&](auto K) {
    const Block b = block<decltype(K)::value>(log_n, log_cp);
    *threads = b.threads;
    *max_threads_ = max_threads<decltype(K)::value>();
    *smem = b.smem;
    *cols = b.cols;
    return 0;
  });
}

// Resident blocks an SM for the instantiation log_r at this block size.
int qzk_ntt_blocks_per_sm(int log_r, int threads, long long smem, int* blocks) {
  return dispatch(log_r, [&](auto K) {
    return blocks_per_sm<decltype(K)::value>(threads, (size_t)smem, blocks);
  });
}

// in: (B, 2^log_n, M) at element strides (sb, sr, sc); out: (B, 2^log_n,
// M) contiguous; stw: (log_n, max(1, n/2)) stage twiddles; twiddle:
// (2^log_n, M) contiguous, or null.  All on the device.  A block of
// qzk_ntt_block's threads takes one tile of its columns of one batch
// entry at a time; `grid` blocks walk the B * tiles units.  flags:
// WIDE_IN | WIDE_OUT, where alignment allows 16-byte accesses.
int qzk_ntt_axis0(const uint64_t* in, long long sb, long long sr, long long sc, uint64_t* out,
                  const uint64_t* stw, const uint64_t* twiddle, int log_n, long long m,
                  long long b, int log_r, int log_cp, int grid, int flags, void* stream) {
  Args a;
  a.in = in;
  a.sb = sb;
  a.sr = sr;
  a.sc = sc;
  a.out = out;
  a.stw = stw;
  a.twiddle = twiddle;
  a.m = m;
  a.log_n = log_n;
  a.log_cp = log_cp;
  a.flags = flags;
  if (log_r < 0 || log_r > log_n || (log_r == 0) != (log_n == 0))
    return (int)cudaErrorInvalidValue;
  return dispatch(log_r,
                  [&](auto K) { return launch<decltype(K)::value>(a, b, grid, stream); });
}

}  // extern "C"
