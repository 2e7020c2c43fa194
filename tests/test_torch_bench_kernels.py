"""The port's kernels benchmark (python3 -m qzk_tpu_torch.benches.kernels)
runs on the CPU at a small size and prints well-formed JSON lines, one
per metric, under the JAX bench's names; the kernels' own lines are
left out there, since the kernels exist only on the card."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kernels_bench_runs_on_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run(
        [sys.executable, "-m", "qzk_tpu_torch.benches.kernels",
         "--device", "cpu", "--log-n", "8", "--poseidon-batch", "6"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    lines = [json.loads(s) for s in res.stdout.splitlines()]
    by_metric = {d["metric"]: d for d in lines}
    assert list(by_metric) == [
        "poseidon_permutations_per_s_torch",
        "poseidon_permutations_per_s",
        "goldilocks_ntt_2pow8_radix2",
        "goldilocks_ntt_2pow8_fourstep_torch",
        "goldilocks_ntt_2pow8",
    ]
    for d in lines:
        assert d["value"] > 0 and d["device"] == "cpu" and d["card"] == "cpu"
        assert d["power_limit"] is None
    assert by_metric["poseidon_permutations_per_s"]["batch"] == 64
    ntt = by_metric["goldilocks_ntt_2pow8"]
    assert ntt["kernel"] in ("radix2", "fourstep_torch")
    assert ntt["roofline_by"] == "bytes" and ntt["roofline_s"] == 2 * 8 * 256 / 3.35e12
    assert ntt["efficiency_pct"] is None
