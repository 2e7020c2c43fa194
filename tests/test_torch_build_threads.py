"""The port's library loaders under threads: the aggregator proves
chunks from several threads of one process, and each may be the first
to need a library.  Eight threads that find no library build it once
(utils/build.py, native/), through a temporary name of their own, and
all load the same file; the kernels' launch counters lose no update."""

import os
import sys
import threading

import pytest

from qzk_tpu_torch import native
from qzk_tpu_torch.ops import ntt_cuda as nc
from qzk_tpu_torch.ops import poseidon_cuda as pc
from qzk_tpu_torch.utils import build

THREADS = 8

SOURCE = """
extern "C" int qzk_answer(void) { return 42; }
"""


def _together(fn):
    """fn() in THREADS threads released at once; their results."""
    barrier = threading.Barrier(THREADS)
    results, errors = [None] * THREADS, []

    def work(i):
        try:
            barrier.wait(timeout=60)
            results[i] = fn()
        except Exception as e:  # reported below, with the thread's index
            errors.append((i, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


def _leftovers(build_dir):
    return [f for f in os.listdir(build_dir) if ".tmp" in f]


def test_threads_build_one_cxx_library(tmp_path, monkeypatch):
    import ctypes

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "answer.cc"
    src.write_text(SOURCE)
    paths = _together(lambda: build.cxx_library("answer", str(src), ["-O1", "-shared", "-fPIC"]))
    assert len(set(paths)) == 1
    libs = [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]
    assert libs == [os.path.basename(paths[0])]
    assert not _leftovers(tmp_path / "build")
    assert ctypes.CDLL(paths[0]).qzk_answer() == 42


def test_compile_names_its_temporary_file_by_process_and_thread(tmp_path, monkeypatch):
    seen = []
    real_run = build.subprocess.run

    def run(cmd, **kw):
        seen.append(cmd[-1])
        return real_run(cmd, **kw)

    monkeypatch.setattr(build.subprocess, "run", run)
    src = tmp_path / "answer.cc"
    src.write_text(SOURCE)
    out = str(tmp_path / "answer.so")
    build._compile(["g++", "-O1", "-shared", "-fPIC", str(src)], out)
    assert seen == [f"{out}.tmp{os.getpid()}.{threading.get_ident()}"]
    assert os.path.exists(out) and not _leftovers(tmp_path)


def test_threads_load_one_native_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("QZK_NO_NATIVE", raising=False)
    libs = _together(native.get_lib)
    assert libs[0] is not None
    assert all(lib is libs[0] for lib in libs)
    built = [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]
    assert len(built) == 1 and built[0].startswith("poseidon_native_")
    assert not _leftovers(tmp_path / "build")


@pytest.mark.parametrize("module, key", [(pc, "permute"), (pc, "hash_rows"), (nc, "ntt_axis0")])
def test_launch_counters_lose_no_update(module, key, monkeypatch):
    monkeypatch.setattr(module, "LAUNCHES", dict.fromkeys(module.LAUNCHES, 0))
    n = 2000

    def bump():
        for _ in range(n):
            if module is pc:
                pc._count(key, (1, 8) if key == "hash_rows" else None)
            else:
                nc._count(key, (1, 2, 3, False, True))

    _together(bump)
    assert module.LAUNCHES[key] == THREADS * n
    module.reset_launches()
    assert module.LAUNCHES[key] == 0
