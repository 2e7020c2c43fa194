"""The NTT CUDA kernel K3 (qzk_tpu_torch/ops/csrc/ntt.cu), checked on the
CPU.

The card is not here, so the kernel source itself is compiled for the
host with g++, as tests/test_torch_poseidon_fast.py does for poseidon.cu
(the same PTX-to-C++ translation of goldilocks.cuh), and a launch runs
every block of the grid in turn.  Inside a block, each thread is a
coroutine (ucontext) that runs until it reaches __syncthreads() or ends;
the threads run one after another, in index order, between barriers, and
a block whose threads disagree on their barriers aborts.  Shared memory
starts filled with garbage, so a read that no barrier orders after its
write sees a wrong value.

The host build is held bit for bit against K3's plain version
(ntt_torch.ntt_axis0) and the JAX package's Pallas kernel in interpret
mode: log_n 0-8, batches 1-3, ragged column counts, row-major and
transposed (strided) inputs, with and without the twiddle block, forward
and inverse stage tables, planted 0, 1 and p-1, and non-canonical words;
at the wrapper's launch plan and at other tile widths, rows a thread,
16-byte accesses on or off, and grids that make a block walk several
tiles.  The host build also logs the exchange's shared-memory accesses,
from which the bank conflicts of the kernel's layout are counted.  Needs
g++ only.
"""

import ctypes
import functools
import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qzk_tpu.ops import ntt as jntt
from qzk_tpu.ops import ntt_pallas as npal
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.ops import ntt_cuda as nc
from qzk_tpu_torch.ops import ntt_torch as ntp
from test_torch_poseidon_fast import _translate

P = 0xFFFFFFFF00000001
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "qzk_tpu_torch", "ops", "csrc")
EDGES = [0, 1, P - 1, P, P + 1, 1 << 63, (1 << 64) - 1]

# cuda_runtime.h for the host: the few runtime calls ntt.cu makes, the
# vector type and intrinsics it uses, and a block scheduler.
HOST_RUNTIME = r"""
#pragma once
#include <ucontext.h>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMultiProcessorCount };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct ulonglong2 { unsigned long long x, y; };
inline ulonglong2 make_ulonglong2(unsigned long long x, unsigned long long y) { return {x, y}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? 132 : 232448;
  return 0;
}
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, F, int, size_t) {
  *b = 1;
  return 0;
}
static dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace hostsim {
inline std::vector<unsigned char> smem;
inline ucontext_t sched;
inline std::vector<ucontext_t> ctx;
inline std::vector<int> state;  // 0 runnable, 1 waiting at a barrier, 2 ended
inline int cur = 0;
inline long long barriers = 0;  // barriers every thread of a block passed
inline int or_acc = 0, or_result = 0;  // __syncthreads_or's predicates
inline std::function<void()> body;
inline bool log_on = false;
inline std::vector<long long> xlog;  // (block, thread, word) of each exchange access
inline int logged(int word) {
  if (log_on) xlog.insert(xlog.end(), {(long long)blockIdx.x, (long long)threadIdx.x, word});
  return word;
}
inline void entry() {
  body();
  state[cur] = 2;
}
template <class F> void launch(dim3 grid, dim3 block, size_t smem_bytes, void*, F f) {
  body = f;
  gridDim = grid;
  blockDim = block;
  const int T = (int)block.x;
  smem.assign(smem_bytes + 16, 0xAB);
  std::vector<std::vector<char>> stacks(T, std::vector<char>(1 << 16));
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by, 0);
      ctx.assign(T, ucontext_t{});
      state.assign(T, 0);
      for (int t = 0; t < T; ++t) {
        getcontext(&ctx[t]);
        ctx[t].uc_stack.ss_sp = stacks[t].data();
        ctx[t].uc_stack.ss_size = stacks[t].size();
        ctx[t].uc_link = &sched;
        makecontext(&ctx[t], entry, 0);
      }
      for (;;) {
        for (int t = 0; t < T; ++t) {
          if (state[t] == 2) continue;
          state[t] = 0;
          cur = t;
          threadIdx = dim3(t, 0, 0);
          swapcontext(&sched, &ctx[t]);
        }
        int ended = 0;
        for (int s : state) ended += s == 2;
        if (ended == T) break;
        if (ended) {
          std::fprintf(stderr, "block (%u, %u): threads disagree on __syncthreads\n", bx, by);
          std::abort();
        }
        ++barriers;
        or_result = or_acc;
        or_acc = 0;
      }
    }
}
}  // namespace hostsim

inline void __syncthreads() {
  hostsim::state[hostsim::cur] = 1;
  swapcontext(&hostsim::ctx[hostsim::cur], &hostsim::sched);
}
inline int __syncthreads_or(int pred) {
  hostsim::or_acc |= pred != 0;
  __syncthreads();
  return hostsim::or_result;
}
"""

HOST_ENTRY = r"""
extern "C" long long host_barriers() { return hostsim::barriers; }
extern "C" void host_log(int on) {
  hostsim::log_on = on;
  hostsim::xlog.clear();
}
extern "C" long long host_log_size() { return (long long)hostsim::xlog.size(); }
extern "C" void host_log_read(long long* dst) {
  for (size_t i = 0; i < hostsim::xlog.size(); ++i) dst[i] = hostsim::xlog[i];
}
extern "C" void host_weak(int op, const uint64_t* a, const uint64_t* b, uint64_t* o,
                          long long n) {
  for (long long i = 0; i < n; ++i) o[i] = op ? gl::sub_weak(a[i], b[i]) : gl::add_weak(a[i], b[i]);
}
"""


@pytest.fixture(scope="module")
def host_k3(tmp_path_factory):
    """ntt.cu compiled for the host."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel source for the host")
    d = tmp_path_factory.mktemp("ntt_host")
    (d / "cuda_runtime.h").write_text(HOST_RUNTIME)
    with open(os.path.join(CSRC, "goldilocks.cuh")) as f:
        (d / "goldilocks.cuh").write_text(_translate(f.read()))
    with open(os.path.join(CSRC, "ntt.cu")) as f:
        src = f.read()
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(hostsim::smem.data());", src)
    src = re.sub(r"(\w+<\w+>)<<<(.*?)>>>\((.*?)\);",
                 r"hostsim::launch(\2, [&] { \1(\3); });", src, flags=re.S)
    src, n_at = re.subn(r"\[lay\.at\((.*?)\)\]", r"[hostsim::logged(lay.at(\1))]", src)
    assert "<<<" not in src and "__shared__" not in src and n_at == 4
    (d / "ntt_host.cpp").write_text(_translate(src) + HOST_ENTRY)
    so = d / "ntt_host.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(d),
                    str(d / "ntt_host.cpp"), "-o", str(so)], check=True)
    lib = nc.bind(ctypes.CDLL(str(so)))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.host_barriers.restype = ll
    lib.host_log.argtypes = [i]
    lib.host_log_size.restype = ll
    lib.host_log_read.argtypes = [vp]
    lib.host_weak.argtypes = [i, vp, vp, vp, ll]
    return lib


def _run(lib, x, stw, tw, log_r, log_cp, grid, wide=True):
    """K3 on the host: x a (b, n, m) uint64 array, possibly a transposed
    view; the flags as ntt_cuda.ntt_axis0 sets them (16-byte accesses off
    when `wide` is false)."""
    b, n, m = x.shape
    sb, sr, sc = (s // 8 for s in x.strides)
    out = np.empty((b, n, m), dtype=np.uint64)
    stw = np.ascontiguousarray(stw, dtype=np.uint64)
    flags = 0
    if wide and m % 2 == 0:
        flags |= 1 if sc == 1 and sr % 2 == 0 and sb % 2 == 0 and x.ctypes.data % 16 == 0 else 0
        flags |= 2 if out.ctypes.data % 16 == 0 and (tw is None or tw.ctypes.data % 16 == 0) else 0
    err = lib.qzk_ntt_axis0(x.ctypes.data, sb, sr, sc, out.ctypes.data, stw.ctypes.data,
                            None if tw is None else tw.ctypes.data, n.bit_length() - 1, m, b,
                            log_r, log_cp, grid, flags, None)
    assert err == 0
    return out


def _plain(x, stw, tw):
    got = ntp.ntt_axis0(gt.from_u64(np.ascontiguousarray(x)), gt.from_u64(stw),
                        None if tw is None else gt.from_u64(tw))
    return gt.to_u64(got)


def _field(rng, shape, canonical=True):
    """Canonical values with 0, 1 and p-1 planted, or any 64-bit words
    with EDGES planted."""
    if canonical:
        x = rng.integers(0, P, size=shape, dtype=np.uint64)
        planted = [0, 1, P - 1]
    else:
        x = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
        planted = EDGES
    flat = x.reshape(-1)
    k = min(flat.size, len(planted))
    flat[:k] = planted[:k]
    flat[flat.size - k:] = planted[:k][::-1]
    return x


def _input(rng, b, log_n, m, strided, canonical=True):
    n = 1 << log_n
    if strided:  # the transpose of a contiguous (b, m, n) array, read in place
        return _field(rng, (b, m, n), canonical).transpose(0, 2, 1)
    return _field(rng, (b, n, m), canonical)


def _plan(lib, b, log_n, m, sms=132, blocks=1):
    """The wrapper's plan, from the host build's block sizes."""
    return nc.launch_plan(b, log_n, m, sms, 232448, functools.partial(nc.block, lib),
                          lambda *a: blocks)


@pytest.mark.parametrize("log_n", [9, 11, 12, 13, 14])
def test_host_k3_large_tiles(host_k3, rng, log_n):
    """Tiles of 2^9 rows (K = 2, four exchanges) and 2^11 (K = 3, three)
    at the wrapper's plan, and 2^12 to 2^14 rows at K = 5 (one column a
    thread, the plain path only), against the plain version on canonical
    and non-canonical words."""
    n, m = 1 << log_n, 3
    stw = ntp.stage_tw_table(log_n, inverse=True)
    for strided, canonical in ((False, True), (True, False)):
        x = _input(rng, 1, log_n, m, strided, canonical)
        tw = _field(rng, (n, m)) if canonical else None
        got = _run(host_k3, x, stw, tw, *_plan(host_k3, 1, log_n, m, sms=1))
        assert (got == _plain(x, stw, tw)).all()


@pytest.mark.parametrize("log_n", range(9))
def test_host_k3_matches_plain(host_k3, rng, log_n):
    """Every batch, ragged width, layout, twiddle and direction at the
    wrapper's plan, bit for bit."""
    n = 1 << log_n
    for inverse in (False, True):
        stw = ntp.stage_tw_table(log_n, inverse)
        for b, m in ((1, 1), (2, 10), (3, 16), (1, 37)):
            for strided in (False, True):
                x = _input(rng, b, log_n, m, strided)
                for tw in (None, _field(rng, (n, m))):
                    got = _run(host_k3, x, stw, tw, *_plan(host_k3, b, log_n, m))
                    assert (got == _plain(x, stw, tw)).all(), (inverse, b, m, strided)


@pytest.mark.parametrize("log_n", [1, 4, 5, 8])
def test_host_k3_noncanonical_words(host_k3, rng, log_n):
    """Any 64-bit input word gives the plain version's bits: a tile with
    a word of p or more takes the plain version's mul, add and sub, and a
    canonical tile beside it in the same launch the weak path."""
    n = 1 << log_n
    stw = ntp.stage_tw_table(log_n)
    for strided in (False, True):
        x = _input(rng, 2, log_n, 12, strided, canonical=False)
        x[0] = _field(rng, (n, 12))  # batch entry 0 canonical
        # column 0 of entry 1 is 2^64 - 1 over zeros: its transform is
        # that word in every row, which the plain version's chains of
        # sub(e, 0) keep as 2^64 - 1
        x[1, :, 0] = 0
        x[1, 0, 0] = (1 << 64) - 1
        for tw in (_field(rng, (n, 12)), None):
            got = _run(host_k3, x, stw, tw, *_plan(host_k3, 2, log_n, 12))
            assert (got == _plain(x, stw, tw)).all()
            if tw is None:
                assert got[1, -1, 0] == (1 << 64) - 1


def test_host_weak_add_sub_are_exact_mod_p(host_k3, rng):
    vals = np.array(EDGES + [P - 2, (1 << 32) - 1, 1 << 32, (1 << 64) - (1 << 32)]
                    + list(rng.integers(0, 1 << 64, size=20, dtype=np.uint64)), dtype=np.uint64)
    a, b = np.repeat(vals, len(vals)), np.tile(vals, len(vals))
    for op, exact in ((0, lambda x, y: x + y), (1, lambda x, y: x - y)):
        out = np.empty_like(a)
        host_k3.host_weak(op, a.ctypes.data, b.ctypes.data, out.ctypes.data, a.size)
        got = [(int(g) - exact(int(x), int(y))) % P for g, x, y in zip(out, a, b)]
        assert got == [0] * a.size, op


@pytest.mark.parametrize("log_n,log_r", [(2, 1), (5, 2), (6, 3), (7, 5), (8, 3)])
def test_host_k3_other_plans(host_k3, rng, log_n, log_r):
    """Fewer rows a thread, every tile width that fits, 16-byte accesses
    off, and grids of one block and of a few (each block then walks
    several tiles, behind the barrier between tiles)."""
    n, b, m = 1 << log_n, 3, 20
    stw = ntp.stage_tw_table(log_n)
    tw = _field(rng, (n, m))
    for strided in (False, True):
        x = _input(rng, b, log_n, m, strided)
        want = _plain(x, stw, tw)
        for log_cp in range(4):
            units = b * -(-m // nc.block(host_k3, log_n, log_r, log_cp).cols)
            for grid in sorted({1, 2, units}):
                for wide in (True, False):
                    got = _run(host_k3, x, stw, tw, log_r, log_cp, grid, wide)
                    assert (got == want).all(), (strided, log_cp, grid, wide)


@pytest.mark.parametrize("log_n,m,mul_tw", [(1, 8, True), (5, 10, True), (8, 16, False),
                                            (8, 24, True)])
def test_host_k3_matches_pallas_kernel(host_k3, rng, log_n, m, mul_tw):
    """The JAX package's kernel in interpret mode takes rows already
    bit-reversed; the host K3 takes them in natural order."""
    n = 1 << log_n
    x = _field(rng, (n, m))
    t = _field(rng, (n, m))
    table = npal._stage_tw_table(log_n)

    def planes(a):
        a = jnp.asarray(np.asarray(a, dtype=np.uint64))
        return ((a & np.uint64(0xFFFFFFFF)).astype(jnp.uint32),
                (a >> np.uint64(32)).astype(jnp.uint32))

    o_lo, o_hi = npal._ntt_axis0_pallas(
        *planes(x[jntt.bit_reverse_perm(log_n)]), *planes(table), *planes(t),
        log_n=log_n, mul_tw=mul_tw, interpret=True)
    want = npal._join_u32(np.asarray(o_lo), np.asarray(o_hi))
    assert (np.asarray(table) == ntp.stage_tw_table(log_n)).all()
    got = _run(host_k3, x[None], table, t if mul_tw else None, *_plan(host_k3, 1, log_n, m))
    assert (got[0] == want).all()


def test_host_k3_barriers_per_tile(host_k3, rng):
    """log_n = 8 at eight rows a thread is three stage groups (bits 0-2,
    3-5, 6-7): two exchange barriers a tile, and the one after its load
    that picks the tile's path."""
    b, log_n, m = 2, 8, 8  # one tile of four pairs a batch entry
    stw = ntp.stage_tw_table(log_n)
    x = _input(rng, b, log_n, m, False)
    before = host_k3.host_barriers()
    got = _run(host_k3, x, stw, None, 3, 2, 1)  # one block walks both tiles
    assert (got == _plain(x, stw, None)).all()
    assert host_k3.host_barriers() - before == 2 * (2 + 1)


# (b, log_n, m) of K3's passes in a warm non-zk Wormhole prove (degree
# 2^13, LDE 2^16, 135 wires, 24 zs and partial products, 2 challenges, 16
# quotient polys) and in the 2^22 NTT
MAIN_PATH = ((135, 7, 64), (135, 6, 128), (135, 8, 256), (24, 7, 64), (24, 6, 128),
             (24, 8, 256), (16, 8, 256), (2, 8, 256), (1, 11, 2048))


def test_launch_plan_fills_the_card(host_k3):
    """The prover's pass shapes and the 2^22 NTT's: four rows a thread up
    to 2^10 rows, eight at 2^11, 32 of one column from 2^12 to 2^14;
    blocks of at most 256 threads (128 where the rows allow) and tiles no
    wider than the columns; a walking wave only between one and two waves
    of tiles."""
    for b, log_n, m in MAIN_PATH:
        log_r, log_cp, grid = _plan(host_k3, b, log_n, m, blocks=3)
        blk = nc.block(host_k3, log_n, log_r, log_cp)
        units = b * -(-m // blk.cols)
        assert log_r == (3 if log_n == 11 else 2) and blk.cols <= m
        assert blk.threads == (256 if log_n == 11 else 128)
        assert grid == (396 if 396 < units < 2 * 396 else units)
    # the 2^22 NTT's (1, 2048, 2048): 1024 tiles of two columns, 256
    # threads each, one a block (2.6 waves of three blocks an SM)
    assert _plan(host_k3, 1, 11, 2048, blocks=3) == (3, 0, 1024)
    # wires iNTT pass 1 (135, 128, 64) at eight blocks an SM: 1080 tiles of
    # 8 columns, 1.02 waves, walked by one wave of 1056 blocks
    assert _plan(host_k3, 135, 7, 64, blocks=8) == (2, 2, 1056)
    # 2^12 to 2^14 rows: one column a thread, up to 512 threads and 128 KB
    assert _plan(host_k3, 1, 12, 8) == (5, 0, 8)
    assert nc.block(host_k3, 14, 5, 0) == (512, 512, 1 << 17, 1)
    assert _plan(host_k3, 3, 14, 5) == (5, 0, 15)
    with pytest.raises(ValueError, match="2\\^15 rows"):
        _plan(host_k3, 1, 15, 8)
    with pytest.raises(RuntimeError):
        nc.block(host_k3, 12, 4, 0)  # no K = 4 instantiation


def _extra_wavefronts(log, word_bytes):
    """Shared-memory wavefronts above the fewest, summed over a block's
    warp-wide exchange accesses, from the host build's log of (block,
    thread, word).  A warp's 16-byte accesses are served in four phases
    of eight threads, its 8-byte ones in two of sixteen; a phase takes
    one wavefront more for each further distinct word in its busiest
    group of banks (word index mod 8, or mod 16)."""
    lanes = 128 // word_bytes
    by_thread = {}
    for blk, t, word in log.reshape(-1, 3).tolist():
        by_thread.setdefault((blk, t), []).append(word)
    counts = {len(v) for v in by_thread.values()}
    assert len(counts) == 1  # every thread makes the same accesses
    threads = sorted(by_thread)
    extra = 0
    for k in range(counts.pop()):
        for w in range(0, len(threads), 32):
            warp = [by_thread[t][k] for t in threads[w:w + 32]]
            for ph in range(0, len(warp), lanes):
                groups = {}
                for word in warp[ph:ph + lanes]:
                    groups.setdefault(word % lanes, set()).add(word)
                extra += max(len(g) for g in groups.values()) - 1
    return extra


def test_host_k3_exchange_has_no_bank_conflicts(host_k3, rng):
    """The kernel's exchange layout, read from the host build's accesses:
    one tile at every launch plan of the main path takes no wavefront
    above the fewest; so does one of 2^14 rows at one column a thread."""
    plans = {(log_n, *_plan(host_k3, b, log_n, m)[:2]) for b, log_n, m in MAIN_PATH}
    assert plans == {(6, 2, 3), (7, 2, 2), (8, 2, 1), (11, 3, 0)}
    for log_n, log_r, log_cp in sorted(plans) + [(14, 5, 0)]:
        blk = nc.block(host_k3, log_n, log_r, log_cp)
        x = _input(rng, 1, log_n, blk.cols, False)
        stw = ntp.stage_tw_table(log_n)
        host_k3.host_log(1)
        got = _run(host_k3, x, stw, None, log_r, log_cp, 1)
        log = np.empty(host_k3.host_log_size(), dtype=np.int64)
        host_k3.host_log_read(log.ctypes.data)
        host_k3.host_log(0)
        assert (got == _plain(x, stw, None)).all()
        assert log.size > 0
        word = 16 if blk.cols == 2 << log_cp else 8
        assert _extra_wavefronts(log, word) == 0, (log_n, log_r, log_cp)


def test_wrapper_takes_the_plain_version_on_cpu(rng):
    x = torch.as_tensor(_field(rng, (2, 16, 6)).view(np.int64))
    stw = gt.from_u64(ntp.stage_tw_table(4))
    assert torch.equal(nc.ntt_axis0(x, stw), ntp.ntt_axis0(x, stw))
