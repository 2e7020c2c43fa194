"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (qzk_tpu_torch begins with qzk_tpu and is no
match); the plain reference loads nothing of the program; without a card
the command exits with 3 and prints no result."""

import ast
import os
import subprocess
import sys

from conftest import BENCH_DIR, ROOT
from harness import cell

FORBIDDEN = {"jax", "jaxlib", "flax", "qzk_tpu"}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"qzk_tpu_torch": 1, "qzk_tpu_torch.ops": 1, "numpy": 1,
                                         "jaxtyping": 1, "qzk_tpu_tools": 1})
    assert cell.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"qzk_tpu.ops": 1, "jaxlib.xla": 1, "qzk_tpu_torch": 1})
    assert cell.forbidden_modules() == ["jaxlib", "qzk_tpu"]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(BENCH_DIR):
        if ".cache" in dirpath:
            continue
        for name in files:
            if not name.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, name)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    tops = {node.module.split(".")[0]}
                else:
                    continue
                assert not tops & FORBIDDEN, (name, tops)
                assert "benches" not in tops and "bench" not in tops, (name, tops)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import reference.verify, reference.withdrawal, reference.formats\n"
            "bad = {m.split('.')[0] for m in sys.modules} & {'qzk_tpu_torch', 'qzk_tpu', 'jax', "
            "'torch'}\n"
            "print(sorted(bad))" % BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


def test_without_a_card_the_command_exits_3_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "wormhole_zk.one_caller", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3 and "{" not in out.stdout, (out.stdout, out.stderr)
