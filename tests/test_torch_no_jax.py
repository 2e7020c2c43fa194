"""The port must run where there is no JAX: no module of qzk_tpu_torch,
and not chip_smoke.py, may import jax, qzk_tpu or the tests.  Its entry
points run on CUDA unless the caller passes device="cpu", and raise
when there is no card rather than dropping to the CPU."""

import os
import pkgutil
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

import qzk_tpu_torch
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.ops import ntt_cuda as nc
from qzk_tpu_torch.ops import ntt_torch as ntp
from qzk_tpu_torch.ops import poseidon_cuda as pc
from qzk_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(qzk_tpu_torch.__path__, "qzk_tpu_torch.")
    )


def test_package_and_chip_smoke_import_no_jax(tmp_path):
    assert {
        "qzk_tpu_torch.ops.threefry",
        "qzk_tpu_torch.benches.prove",
        "qzk_tpu_torch.models.voting",
        "qzk_tpu_torch.models.voting.circuit",
        "qzk_tpu_torch.models.voting.fixtures",
        "qzk_tpu_torch.plonk.recursion",
        "qzk_tpu_torch.models.wormhole.aggregator",
        "qzk_tpu_torch.benches.aggregate",
        "qzk_tpu_torch.utils.serialization",
        "qzk_tpu_torch.utils.plonky2_compat",
        "qzk_tpu_torch.utils.plonky2_write",
        "qzk_tpu_torch.utils.plonky2_verify",
        "qzk_tpu_torch.models.wormhole.circuit_builder",
        "qzk_tpu_torch.models.wormhole.example",
        "qzk_tpu_torch.tools",
        "qzk_tpu_torch.tools.build_chunk_cache",
        "qzk_tpu_torch.benches.verify",
        "qzk_tpu_torch.plonk.device_prover",
        "qzk_tpu_torch.tools.profile_prover",
        "qzk_tpu_torch.tools.export_dummy_proof",
        "qzk_tpu_torch.parallel",
        "qzk_tpu_torch.parallel.sharded",
        "qzk_tpu_torch.parallel.kernels",
        "qzk_tpu_torch.parallel.ntt_sharded",
        "qzk_tpu_torch.parallel.prover_sharded",
        "qzk_tpu_torch.benches.ntt_sharded",
        "qzk_tpu_torch.ops.goldilocks_cuda",
    } <= set(_modules())
    code = textwrap.dedent(
        f"""
        import importlib, sys
        sys.path.insert(0, {ROOT!r})
        for name in {_modules()!r} + ["chip_smoke"]:
            importlib.import_module(name)
        bad = sorted(
            k for k in sys.modules
            if k.split(".")[0] in ("jax", "jaxlib", "qzk_tpu", "tests", "fixtures")
        )
        assert not bad, bad
        print("ok", len(sys.modules))
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_sources_name_no_jax_import():
    pkg = os.path.dirname(qzk_tpu_torch.__file__)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for bad in ("import jax", "from jax", "import qzk_tpu\n", "from qzk_tpu.", "from qzk_tpu import"):
                    assert bad not in text, (f, bad)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("zk", [False, True], ids=["nonzk", "zk"])
def test_prove_without_a_card_raises_unless_cpu_is_asked(monkeypatch, zk):
    from qzk_tpu_torch.plonk.builder import CircuitBuilder
    from qzk_tpu_torch.plonk.config import CircuitConfig
    from qzk_tpu_torch.plonk.witness import PartialWitness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config().with_zero_knowledge(zk))
    x = builder.add_virtual_target()
    builder.register_public_input(builder.mul(x, x))
    data = builder.build()
    pw = PartialWitness()
    pw.set_target(x, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.prove(pw)


def test_kernel_wrappers_take_the_plain_version_only_for_cpu_tensors():
    x = gt.from_u64([[1, 2, 3, 4, 5, 6, 7, 8, 9]])
    assert pc.hash_no_pad_rows(x).shape == (1, 4)
    with pytest.raises(ValueError):
        pc.hash_no_pad_rows(x.to("meta"))


def test_cuda_build_needs_nvcc():
    """Without nvcc the kernels' build raises; nothing falls back."""
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            pc.library_path()
    else:
        assert os.path.exists(pc.library_path())


def test_ntt_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    x = gt.from_u64([[1, 2], [3, 4], [5, 6], [7, 8]])
    stw = gt.from_u64(ntp.stage_tw_table(2))
    assert torch.equal(nc.ntt_axis0(x, stw), ntp.ntt_axis0(x, stw))
    assert nc.LAUNCHES["ntt_axis0"] == 0
    with pytest.raises(ValueError):
        nc.ntt_axis0(x.to("meta"), stw.to("meta"))
    with pytest.raises(ValueError, match="power of two"):
        nc.ntt_axis0(x[:3], stw)
    with pytest.raises(ValueError, match="stage_tw"):
        nc.ntt_axis0(x, stw[:1])
    with pytest.raises(ValueError, match="twiddle"):
        nc.ntt_axis0(x, stw, x[:, :1].contiguous())
    with pytest.raises(TypeError):
        nc.ntt_axis0(x.to(torch.int32), stw)


def test_ntt_kernel_build_needs_nvcc():
    """Without nvcc the NTT kernel's build raises; nothing falls back."""
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            nc.library_path()
    else:
        assert os.path.exists(nc.library_path())
