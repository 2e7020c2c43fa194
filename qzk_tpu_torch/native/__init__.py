"""Native (C++) host-side kernels, loaded via ctypes.

The shared object is built lazily from poseidon_native.cc with g++ -O3
into the port's build directory (utils/build.py), keyed by a hash of the
source.  All entry points fall back to the numpy implementations when the toolchain
is unavailable, so the package stays importable everywhere.

Why native: witness generation runs inherently sequential hash-chain
levels (Merkle paths, sponge absorption) in ~500 small batches — numpy
per-call overhead dominates there, while C++ computes each 64x64->128
modular product in two instructions.  The bulk (data-parallel) prover
work runs on the GPU (plonk/device_prover.py).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "poseidon_native.cc")
_lock = threading.Lock()
_lib = None
_tried = False


def _build_and_load():
    from ..utils import build

    so_path = build.cxx_library(
        "poseidon_native", _SRC,
        ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"],
    )
    lib = ctypes.CDLL(so_path)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u64 = ctypes.c_uint64
    # void_p (not POINTER(u64)) so callers can pass ndarray.ctypes.data
    # ints directly — data_as(POINTER) costs ~3.5 µs per argument, which
    # dominated the host verifier's small-array dispatch
    vp = ctypes.c_void_p
    lib.gl_mul.argtypes = [vp, vp, vp, ctypes.c_long]
    lib.gl_add.argtypes = [vp, vp, vp, ctypes.c_long]
    lib.gl_sub.argtypes = [vp, vp, vp, ctypes.c_long]
    lib.gl_mul_sa.argtypes = [u64, vp, vp, ctypes.c_long]
    lib.gl_add_sa.argtypes = [u64, vp, vp, ctypes.c_long]
    lib.gl_sub_as.argtypes = [vp, u64, vp, ctypes.c_long]
    lib.gl_sub_sa.argtypes = [u64, vp, vp, ctypes.c_long]
    lib.poseidon_permute.argtypes = [
        u64p, ctypes.c_long, u64p, u64p, ctypes.c_int, ctypes.c_int,
    ]
    lib.poseidon_hash_rows.argtypes = [
        u64p, ctypes.c_long, ctypes.c_long, u64p, u64p,
        ctypes.c_int, ctypes.c_int, u64p,
    ]
    lib.poseidon_merkle_walk.argtypes = [
        u64p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_long, u64p,
        ctypes.c_long, u64p, u64p, ctypes.c_int, ctypes.c_int,
    ]
    lib.challenger_absorb.argtypes = [
        u64p, ctypes.c_long, u64p, ctypes.c_long, u64p, u64p,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.challenger_absorb.restype = ctypes.c_long
    lib.poseidon_trace.argtypes = [
        u64p, u64p, ctypes.c_long, u64p, u64p, ctypes.c_int,
        ctypes.c_int, u64p, u64p, u64p,
    ]
    i64p = ctypes.POINTER(ctypes.c_long)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.run_witness_plan.argtypes = [
        u64p, u8p,  # values, known
        i64p, ctypes.c_long,  # batch_table, n_batches
        i64p, u64p,  # const
        u64p, u64p, i64p, i64p, i64p, i64p,  # arith
        i64p, i64p,  # inv
        i64p, i64p,  # bits
        i64p, i64p, i64p, i64p,  # poseidon
        u64p, u64p, ctypes.c_int, ctypes.c_int,  # mds, rc, rounds
        ctypes.c_int,  # max_threads
        i64p,  # err_info
    ]
    lib.run_witness_plan.restype = ctypes.c_long
    lib.gl_ntt_rows.argtypes = [
        u64p, ctypes.c_long, ctypes.c_long, u64p, ctypes.c_int,
    ]
    lib.poseidon_set_fast_tables.argtypes = [
        u64p, ctypes.c_int, ctypes.c_int, u64, u64,
    ]
    try:
        from ..ops import poseidon as pos

        tables, n_partial = _fast_partial_tables()
        # fingerprint of the constants the tables were derived from —
        # permute_one only takes the fast path when the caller's
        # constants match (ADVICE r4: protects future C-ABI callers
        # with different Poseidon constants from silent wrong hashes)
        lib.poseidon_set_fast_tables(
            _ptr(tables),
            n_partial,
            pos.HALF_FULL,
            int(pos.MDS_MATRIX[0][0]),
            int(pos._RC[pos.HALF_FULL][0]),
        )
    except Exception:
        pass  # naive permutation path remains correct without tables
    return lib


def _fast_partial_tables() -> tuple[np.ndarray, int]:
    """Derive the fast partial-round tables (Poseidon paper, appendix
    B) exactly mod p.  Each partial round r applies x -> M(sbox0(x+c));
    keeping an implicit pending dense matrix D_r = Mh^r on coords 1..11
    turns that into one sbox + a sparse update with precomputed
    vectors:  c_hat_r = D_r^-1 c_r[1:],  v_row_r = v^T D_r,
    w_hat_r = (Mh D_r)^-1 w,  plus one final dense 11x11 apply.
    Layout per round: [c0 | c_hat(11) | v_row(11) | w_hat(11)]; tail =
    D_final row-major (121).  Bit-exactness vs the naive permutation is
    covered by tests/test_poseidon.py (native vs numpy oracle)."""
    from ..ops import poseidon as pos

    p = 0xFFFFFFFF00000001
    width = pos.WIDTH
    n_partial = pos.N_PARTIAL_ROUNDS
    m = [[int(pos.MDS_MATRIX[r][c]) for c in range(width)]
         for r in range(width)]
    rc = np.asarray(pos._RC)
    v = [m[0][c] for c in range(1, width)]
    w = [m[r][0] for r in range(1, width)]
    mh = [[m[r][c] for c in range(1, width)] for r in range(1, width)]
    n = width - 1

    def mat_mul(a, b):
        return [
            [sum(a[i][t] * b[t][j] for t in range(n)) % p for j in range(n)]
            for i in range(n)
        ]

    def mat_vec(a, x):
        return [sum(r * e for r, e in zip(row, x)) % p for row in a]

    def mat_inv(a):
        aug = [
            [a[i][j] % p for j in range(n)]
            + [1 if i == j else 0 for j in range(n)]
            for i in range(n)
        ]
        for col in range(n):
            piv = next(r for r in range(col, n) if aug[r][col] % p)
            aug[col], aug[piv] = aug[piv], aug[col]
            inv = pow(aug[col][col], p - 2, p)
            aug[col] = [x * inv % p for x in aug[col]]
            for r in range(n):
                if r != col and aug[r][col]:
                    f = aug[r][col]
                    aug[r] = [
                        (x - f * y) % p for x, y in zip(aug[r], aug[col])
                    ]
        return [row[n:] for row in aug]

    d = [[1 if i == j else 0 for j in range(n)] for i in range(n)]
    flat: list[int] = []
    for r in range(n_partial):
        c = [int(x) for x in rc[pos.HALF_FULL + r]]
        flat.append(c[0])
        flat += mat_vec(mat_inv(d), c[1:])
        flat += mat_vec([[d[i][j] for i in range(n)] for j in range(n)], v)
        d = mat_mul(mh, d)
        flat += mat_vec(mat_inv(d), w)
    flat += [d[i][j] for i in range(n) for j in range(n)]
    return np.array(flat, dtype=np.uint64), n_partial


def get_lib():
    """The loaded native library, or None if the build failed."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            if os.environ.get("QZK_NO_NATIVE") == "1":
                _lib = None
            else:
                try:
                    _lib = _build_and_load()
                except Exception:
                    _lib = None
            _tried = True
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def ntt_rows(values: np.ndarray, tw: np.ndarray) -> np.ndarray | None:
    """Forward radix-2 NTT along rows of (R, n) uint64 (bit-reversal
    included).  tw is the stage-twiddle table from ops/ntt.py
    (_stage_twiddles).  None if native unavailable."""
    out = np.ascontiguousarray(values, dtype=np.uint64).copy()
    if ntt_rows_inplace(out, tw):
        return out
    return None


def ntt_rows_inplace(values: np.ndarray, tw: np.ndarray) -> bool:
    """In-place variant for callers that own a contiguous buffer
    (avoids a full-size copy on the multi-GB LDE arrays)."""
    lib = get_lib()
    if lib is None:
        return False
    assert values.dtype == np.uint64 and values.flags.c_contiguous
    rows = values.shape[0] if values.ndim == 2 else 1
    n = values.shape[-1]
    n_threads = min(rows, os.cpu_count() or 1)
    lib.gl_ntt_rows(
        _ptr(values), rows, n, _ptr(np.ascontiguousarray(tw)), n_threads
    )
    return True


def poseidon_permute_batch(states: np.ndarray) -> np.ndarray:
    """(B, 12) uint64 -> permuted copy, or None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from ..ops import poseidon as pos

    out = np.ascontiguousarray(states, dtype=np.uint64).copy()
    lib.poseidon_permute(
        _ptr(out), out.shape[0], _ptr(_mds()), _ptr(_rc()),
        pos.HALF_FULL, pos.N_PARTIAL_ROUNDS,
    )
    return out


def poseidon_hash_rows(rows: np.ndarray) -> np.ndarray | None:
    """Rate-8 no-pad sponge over rows: (B, w) -> (B, 4) digests in ONE
    native call (vs ceil(w/8) permute dispatches)."""
    lib = get_lib()
    if lib is None:
        return None
    from ..ops import poseidon as pos

    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    B, w = rows.shape
    out = np.empty((B, 4), dtype=np.uint64)
    lib.poseidon_hash_rows(
        _ptr(rows), B, w, _ptr(_mds()), _ptr(_rc()),
        pos.HALF_FULL, pos.N_PARTIAL_ROUNDS, _ptr(out),
    )
    return out


def poseidon_merkle_walk(
    digests: np.ndarray, idx: np.ndarray, paths: np.ndarray
) -> np.ndarray | None:
    """Walk Q Merkle paths: digests (Q, 4), idx (Q,), paths
    (Q, depth, 4) -> (Q, 4) top digests in ONE native call."""
    lib = get_lib()
    if lib is None:
        return None
    from ..ops import poseidon as pos

    out = np.ascontiguousarray(digests, dtype=np.uint64).copy()
    idx_c = np.ascontiguousarray(idx, dtype=np.int64)
    paths = np.ascontiguousarray(paths, dtype=np.uint64)
    Q, depth = paths.shape[0], paths.shape[1]
    lib.poseidon_merkle_walk(
        _ptr(out),
        idx_c.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        Q, _ptr(paths), depth, _ptr(_mds()), _ptr(_rc()),
        pos.HALF_FULL, pos.N_PARTIAL_ROUNDS,
    )
    return out


def challenger_absorb(
    state: np.ndarray, k: int, elems: np.ndarray
) -> int | None:
    """Absorb `elems` into the duplex `state` (modified in place) with
    `k` elements already pending; returns the new pending count, or
    None if native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from ..ops import poseidon as pos

    assert state.dtype == np.uint64 and state.flags.c_contiguous
    elems = np.ascontiguousarray(elems, dtype=np.uint64)
    return int(
        lib.challenger_absorb(
            _ptr(state), k, _ptr(elems), elems.size, _ptr(_mds()),
            _ptr(_rc()), pos.HALF_FULL, pos.N_PARTIAL_ROUNDS,
        )
    )


_mds_cache = None
_rc_cache = None


def _mds():
    global _mds_cache
    if _mds_cache is None:
        from ..ops import poseidon as pos

        _mds_cache = np.ascontiguousarray(pos.MDS_MATRIX, dtype=np.uint64)
    return _mds_cache


def _rc():
    global _rc_cache
    if _rc_cache is None:
        from ..ops import poseidon as pos

        _rc_cache = np.ascontiguousarray(pos._RC, dtype=np.uint64)
    return _rc_cache


def run_witness_plan(values, known, native_plan, max_threads: int = 0):
    """Execute a compiled witness plan natively (see
    plonk/witness.py::_NativePlan for the layout).  Returns the error
    tuple (code, err_info) with code 0 on success, or None when the
    native library is unavailable.  err_info[4:7] hold the threads the
    run used, the items of the batches it split across them and all its
    items.  The batches marked for it run on the process's witness
    thread pool, capped at `max_threads` threads (0: the pool's size,
    1: the calling thread alone)."""
    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    from ..ops import poseidon as pos

    p64 = ctypes.POINTER(ctypes.c_uint64)
    pi64 = ctypes.POINTER(ctypes.c_long)
    p8 = ctypes.POINTER(ctypes.c_uint8)
    np_ = native_plan
    err = np.zeros(8, dtype=np.int64)
    code = lib.run_witness_plan(
        values.ctypes.data_as(p64),
        known.ctypes.data_as(p8),
        np_.batch_table.ctypes.data_as(pi64),
        np_.batch_table.shape[0],
        np_.const_ids.ctypes.data_as(pi64),
        np_.const_vals.ctypes.data_as(p64),
        np_.arith_c0.ctypes.data_as(p64),
        np_.arith_c1.ctypes.data_as(p64),
        np_.arith_m0.ctypes.data_as(pi64),
        np_.arith_m1.ctypes.data_as(pi64),
        np_.arith_a.ctypes.data_as(pi64),
        np_.arith_out.ctypes.data_as(pi64),
        np_.inv_x.ctypes.data_as(pi64),
        np_.inv_out.ctypes.data_as(pi64),
        np_.bits_val.ctypes.data_as(pi64),
        np_.bits_out.ctypes.data_as(pi64),
        np_.pos_in.ctypes.data_as(pi64),
        np_.pos_swap.ctypes.data_as(pi64),
        np_.pos_internal.ctypes.data_as(pi64),
        np_.pos_out.ctypes.data_as(pi64),
        _ptr(_mds()),
        _ptr(_rc()),
        pos.HALF_FULL,
        pos.N_PARTIAL_ROUNDS,
        max_threads,
        err.ctypes.data_as(pi64),
    )
    return int(code), err


def poseidon_trace_batch(inputs: np.ndarray, swap: np.ndarray):
    """(B, 12) inputs + (B,) swap -> (deltas (B,4), stored (B,106),
    outputs (B,12)), or None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from ..ops import poseidon as pos

    B = inputs.shape[0]
    inputs = np.ascontiguousarray(inputs, dtype=np.uint64)
    swap = np.ascontiguousarray(swap, dtype=np.uint64)
    stored_w = (pos.HALF_FULL - 1) * 12 + pos.N_PARTIAL_ROUNDS + pos.HALF_FULL * 12
    deltas = np.empty((B, 4), dtype=np.uint64)
    stored = np.empty((B, stored_w), dtype=np.uint64)
    outputs = np.empty((B, 12), dtype=np.uint64)
    lib.poseidon_trace(
        _ptr(inputs), _ptr(swap), B, _ptr(_mds()), _ptr(_rc()),
        pos.HALF_FULL, pos.N_PARTIAL_ROUNDS,
        _ptr(deltas), _ptr(stored), _ptr(outputs),
    )
    return deltas, stored, outputs
