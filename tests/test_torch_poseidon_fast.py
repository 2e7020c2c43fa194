"""The arithmetic of the Poseidon CUDA kernels (K1, K2) in
qzk_tpu_torch/ops/csrc, checked on the CPU.

The card is not here, so the kernel source itself is compiled for the
host: g++ builds poseidon.cu and goldilocks.cuh with the CUDA qualifiers
stubbed out and each inline PTX instruction turned into the C++ it
computes (a 32-bit operation with an explicit carry flag).  The host
build's permutation is then held, bit for bit, against the port's plain
version and the JAX package's, on canonical states and on states with
0, 1, p-1, 2^63 and 2^64-1 planted in every lane; its field operations
against the plain torch ones; and its weak operations (any 64-bit word
congruent mod p) against exact integer arithmetic.  A state built by
running the permutation backwards makes the weak rounds end on a word
above p, so that the final canonical step is seen to work.  The MDS
immediates in the source are checked against MDS_MATRIX.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

import chip_smoke
from qzk_tpu.ops import poseidon as jpos
from qzk_tpu.ops import poseidon_jax as pj
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.ops import poseidon as pos
from qzk_tpu_torch.ops import poseidon_torch as pt

P = 0xFFFFFFFF00000001
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "qzk_tpu_torch", "ops", "csrc")
EDGES = [0, 1, 2, P - 2, P - 1, P, P + 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
         1 << 63, P - (1 << 32), (1 << 64) - (1 << 32), (1 << 64) - 2, (1 << 64) - 1]

CUDA_STUBS = r"""
#pragma once
#include <algorithm>
#include <cstdint>
#include <cstring>
using std::min;
#define __device__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
template <class T, class U> int cudaMemcpyToSymbol(T& sym, const U* src, size_t n) {
  std::memcpy(&sym, src, n);
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline void __syncthreads() {}
struct HostDim { unsigned x = 0, y = 0, z = 0; };
static HostDim threadIdx, blockIdx;
"""

HOST_ENTRY = r"""
extern "C" {
void host_permute(uint64_t* s, long long b) {
  for (long long i = 0; i < b; ++i) permute(s + 12 * i);
}
void host_rounds(uint64_t* s, long long b) {
  for (long long i = 0; i < b; ++i) rounds(s + 12 * i);
}
void host_mds(uint64_t* s, long long b) {
  for (long long i = 0; i < b; ++i) mds(s + 12 * i);
}
void host_field(int op, const uint64_t* a, const uint64_t* b, uint64_t* o, long long n) {
  for (long long i = 0; i < n; ++i) {
    const uint32_t r[4] = {(uint32_t)a[i], (uint32_t)(a[i] >> 32), (uint32_t)b[i],
                           (uint32_t)(b[i] >> 32)};
    switch (op) {
      case 0: o[i] = gl::mul(a[i], b[i]); break;
      case 1: o[i] = gl::add(a[i], b[i]); break;
      case 2: o[i] = gl::sub(a[i], b[i]); break;
      case 3: o[i] = gl::mul_weak(a[i], b[i]); break;
      case 4: o[i] = gl::reduce_weak(r); break;
      case 5: o[i] = gl::reduce96_weak(a[i], (uint32_t)b[i]); break;
      case 6: o[i] = add_rc(a[i], b[i]); break;
      case 7: o[i] = gl::canonical(a[i]); break;
    }
  }
}
}
"""

FIELD_OPS = {"mul": 0, "add": 1, "sub": 2, "mul_weak": 3, "reduce_weak": 4,
             "reduce96_weak": 5, "add_rc": 6, "canonical": 7}


def _ptx_to_cpp(stmt: str) -> str:
    """One inline asm statement (template, outputs, inputs) as C++."""
    parts = stmt.split(":")
    template = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', parts[0]))
    operands = [m.group(1).strip() for part in parts[1:3]
                for m in re.finditer(r'"[=&+]*\w"\s*\(((?:[^()]|\([^()]*\))*)\)', part)]

    def val(tok):
        tok = tok.strip()
        m = re.fullmatch(r"%(\d+)", tok)
        return f"({operands[int(m.group(1))]})" if m else f"(uint64_t){tok}u"

    code = ["{ uint64_t cf = 0, t = 0; (void)cf; (void)t;"]
    for line in template.replace("\\n", "\n").replace("\\t", " ").split(";"):
        line = line.strip().strip("{}").strip()
        if not line:
            continue
        op, args = line.split(None, 1)
        dst, *src = [val(x) for x in args.split(",")]
        u32 = [f"(uint64_t)(uint32_t){x}" for x in src]
        name = op.split(".")[0]
        if op == "mad.wide.u32":
            code.append(f"{dst} = {u32[0]} * {u32[1]} + (uint64_t){src[2]};")
            continue
        if name in ("mul", "mad", "madc"):
            prod = f"({u32[0]} * {u32[1]})"
            expr = f"({prod} >> 32)" if ".hi" in op else f"({prod} & 0xFFFFFFFFull)"
            if name != "mul":
                expr += f" + {u32[2]}" + (" + cf" if name == "madc" else "")
        elif name in ("add", "addc"):
            expr = f"{u32[0]} + {u32[1]}" + (" + cf" if name == "addc" else "")
        elif name in ("sub", "subc"):
            expr = f"{u32[0]} - {u32[1]}" + (" - cf" if name == "subc" else "")
        elif op == "neg.s32":
            expr = f"0ull - {u32[0]}"
        else:
            raise NotImplementedError(f"PTX instruction {op}")
        code.append(f"t = {expr};")
        if ".cc" in op:  # the carry, or the borrow as the wrapped bit 32
            code.append("cf = (t >> 32) & 1;")
        code.append(f"{dst} = (uint32_t)t;")
    return " ".join(code + ["}"])


def _translate(src: str) -> str:
    out, i = [], 0
    while (j := src.find("asm(", i)) >= 0:
        depth, k = 0, j + 3
        while True:
            depth += {"(": 1, ")": -1}.get(src[k], 0)
            if depth == 0:
                break
            k += 1
        out += [src[i:j], _ptx_to_cpp(src[j + 4:k])]
        i = k + 2  # past ");"
    return "".join(out + [src[i:]])


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """poseidon.cu compiled for the host, with its round constants set."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel source for the host")
    d = tmp_path_factory.mktemp("poseidon_host")
    (d / "cuda_runtime.h").write_text(CUDA_STUBS)
    with open(os.path.join(CSRC, "goldilocks.cuh")) as f:
        (d / "goldilocks.cuh").write_text(_translate(f.read()))
    with open(os.path.join(CSRC, "poseidon.cu")) as f:
        src = re.sub(r"<<<.*?>>>", "", f.read())
    (d / "poseidon_host.cpp").write_text(_translate(src) + HOST_ENTRY)
    so = d / "poseidon_host.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(d),
                    str(d / "poseidon_host.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.qzk_poseidon_init.argtypes = [vp]
    for f in (lib.host_permute, lib.host_rounds, lib.host_mds):
        f.argtypes = [vp, ctypes.c_longlong]
    lib.host_field.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_longlong]
    rc = np.ascontiguousarray(pos._RC, dtype=np.uint64)
    assert lib.qzk_poseidon_init(rc.ctypes.data) == 0
    return lib


def _states(rng, b, canonical):
    x = rng.integers(0, P if canonical else 1 << 64, size=(b, 12), dtype=np.uint64)
    if not canonical:
        planted = np.array([0, 1, P - 1, 1 << 63, (1 << 64) - 1], dtype=np.uint64)
        x[:5] = planted[:, None]  # each value in every lane
        x[5:10] = np.roll(np.resize(planted, 12), 1)[None]  # mixed in one state
    return x


def _field(lib, op, a, b):
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    out = np.empty_like(a)
    lib.host_field(FIELD_OPS[op], a.ctypes.data, b.ctypes.data, out.ctypes.data, a.size)
    return out


def _pairs(rng):
    vals = np.array(EDGES + list(rng.integers(0, 1 << 64, size=20, dtype=np.uint64)),
                    dtype=np.uint64)
    return np.repeat(vals, len(vals)), np.tile(vals, len(vals))


def _inverse_permute(out):
    """The input whose permutation is `out`, with Python integers."""
    m = [[int(v) for v in row] for row in pos.MDS_MATRIX]
    aug = [row + [int(i == j) for j in range(12)] for i, row in enumerate(m)]
    for col in range(12):  # Gauss-Jordan mod p
        piv = next(r for r in range(col, 12) if aug[r][col])
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], P - 2, P)
        aug[col] = [x * inv % P for x in aug[col]]
        for r in range(12):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(x - f * y) % P for x, y in zip(aug[r], aug[col])]
    m_inv = [row[12:] for row in aug]
    root7 = pow(7, -1, P - 1)
    s = [int(v) for v in out]
    for r in reversed(range(pos.N_ROUNDS)):
        s = [sum(a * x for a, x in zip(row, s)) % P for row in m_inv]
        full = r < pos.HALF_FULL or r >= pos.HALF_FULL + pos.N_PARTIAL_ROUNDS
        s = [pow(x, root7, P) if full or i == 0 else x for i, x in enumerate(s)]
        s = [(x - int(c)) % P for x, c in zip(s, pos._RC[r])]
    return s


def test_mds_immediates_match_mds_matrix():
    with open(os.path.join(CSRC, "poseidon.cu")) as f:
        src = f.read()

    def array(name):
        body = re.search(rf"{name}\[WIDTH\] = \{{([^}}]*)\}}", src).group(1)
        return [int(v) for v in body.split(",")]

    circ, diag = array("MDS_CIRC"), array("MDS_DIAG")
    m = np.array([[circ[(c - r) % 12] + (diag[r] if r == c else 0) for c in range(12)]
                  for r in range(12)], dtype=np.uint64)
    assert (m == pos.MDS_MATRIX).all()
    assert (m == jpos.MDS_MATRIX).all()


@pytest.mark.parametrize("canonical", [True, False], ids=["canonical", "noncanonical"])
def test_host_kernel_permute_matches_plain_and_jax(host_kernels, rng, canonical):
    x = _states(rng, 200, canonical)
    got = x.copy()
    host_kernels.host_permute(got.ctypes.data, len(got))
    assert (got == gt.to_u64(pt.permute(gt.from_u64(x)))).all()
    assert (got == np.asarray(pj.permute_batch_u64(x))).all()


def test_host_kernel_permute_canonicalizes_its_output(host_kernels):
    # The last MDS layer maps (v0, 0, ..., 0) to 25 v0 in lane 0; the
    # least v0 with 25 v0 >= p leaves the weak rounds on p + 4.
    v0 = -(-P // 25)
    out = np.array([int(m) * v0 % P for m in pos.MDS_MATRIX[:, 0]], dtype=np.uint64)
    x = np.array(_inverse_permute(out), dtype=np.uint64)
    assert (x == chip_smoke.NONCANONICAL_OUTPUT_STATE).all()
    weak = x[None].copy()
    host_kernels.host_rounds(weak.ctypes.data, 1)
    assert int(weak[0, 0]) == 25 * v0 == P + 4
    got = x[None].copy()
    host_kernels.host_permute(got.ctypes.data, 1)
    assert (got[0] == out).all()
    assert (gt.to_u64(pt.permute(gt.from_u64(x[None])))[0] == out).all()
    assert (np.asarray(pj.permute_batch_u64(x[None]))[0] == out).all()


def test_host_kernel_mds_is_the_mds_mod_p(host_kernels, rng):
    x = _states(rng, 50, canonical=False)
    got = x.copy()
    host_kernels.host_mds(got.ctypes.data, len(got))
    want = [[sum(int(m) * int(v) for m, v in zip(row, s)) % P for row in pos.MDS_MATRIX]
            for s in x]
    assert (got.astype(object) % P == np.array(want, dtype=object)).all()


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_host_kernel_field_ops_match_plain(host_kernels, rng, op):
    a, b = _pairs(rng)
    want = gt.to_u64(getattr(gt, op)(gt.from_u64(a), gt.from_u64(b)))
    assert (_field(host_kernels, op, a, b) == want).all()


def test_host_kernel_weak_ops_are_exact_mod_p(host_kernels, rng):
    a, b = _pairs(rng)
    b_rc = b % np.uint64(P)  # add_rc takes a round constant, below p
    b_96 = b & np.uint64(0xFFFFFFFF)
    cases = {
        "mul_weak": (b, [x * y for x, y in zip(a.tolist(), b.tolist())]),
        "reduce_weak": (b, [x + (y << 64) for x, y in zip(a.tolist(), b.tolist())]),
        "reduce96_weak": (b_96, [x + (y << 64) for x, y in zip(a.tolist(), b_96.tolist())]),
        "add_rc": (b_rc, [x + y for x, y in zip(a.tolist(), b_rc.tolist())]),
    }
    for op, (second, exact) in cases.items():
        got = _field(host_kernels, op, a, second).tolist()
        assert [(g - e) % P for g, e in zip(got, exact)] == [0] * len(got), op
    assert (_field(host_kernels, "canonical", a, b) == a % np.uint64(P)).all()
