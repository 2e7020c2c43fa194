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


def test_bound_uses_the_32bit_integer_multiply_rate():
    # without a card: 64 multiplies a clock on each of the H100 SXM's 132
    # SMs at 1.98 GHz, and K1's bound at the wires tree's (65536, 135)
    from qzk_tpu_torch.benches import kernels as kb

    assert kb.peak_int_muls() == 64 * 132 * 1.98e9
    nbytes = 65536 * 135 * 8 + 65536 * 4 * 8
    ms, by = kb.bound_ms(nbytes, 65536 * 17 * kb.INT_MULS_PER_PERM)
    assert by == "operations"
    assert ms == 65536 * 17 * 11360 / (64 * 132 * 1.98e9) * 1e3


def test_sass_reader_counts_kernels_and_loop_bodies():
    from qzk_tpu_torch.benches import sass

    body = [f"        /*{16 * (i + 2):04x}*/                   IMAD.WIDE.U32 R2, R3, 0x11, R4 ;"
            for i in range(60)]
    text = "\n".join([
        "\t\tFunction : _Z6kernelPm",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
        "        /*0010*/               @P0 IADD3 R5, R5, 0x1, RZ ;",
        *body,
        f"        /*{16 * 62:04x}*/               @!P1 BRA 0x20 ;",
        f"        /*{16 * 63:04x}*/                   EXIT ;",
    ])
    kernels = sass.parse(text)
    assert list(kernels) == ["_Z6kernelPm"]
    ins = kernels["_Z6kernelPm"]
    assert len(ins) == 64 and ins[1][1] == "IADD3"
    assert sass.loops(ins) == [{"start": "0x20", "instructions": 61, "BAR": 0, "LDS": 0,
                                "STS": 0, "opcodes": {"IMAD": 60, "BRA": 1}}]


def test_sass_reader_counts_k3_barriers_and_shared_accesses():
    # a K3 instantiation (K = 3): a tile loop around a stage-group loop
    # whose body holds the exchange (STS, BAR, LDS) and 95 butterfly
    # instructions; a group body is a loop with one barrier
    from qzk_tpu_torch.benches import sass

    def at(i):
        return f"/*{16 * i:04x}*/"

    lines = ["\t\tFunction : _ZN12_GLOBAL__N_116ntt_axis0_kernelILi3EEEvNS_4ArgsE",
             f"        {at(0)}                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;"]
    group = ([f"        {at(1 + i)}                   STS.128 [R3], R4 ;" for i in range(16)]
             + [f"        {at(17)}                   BAR.SYNC.DEFER_BLOCKING 0x0 ;"]
             + [f"        {at(18 + i)}                   LDS.128 R4, [R3] ;" for i in range(16)]
             + [f"        {at(34 + i)}                   IMAD.WIDE.U32 R6, R4, R5, RZ ;"
                for i in range(95)]
             + [f"        {at(129)}               @P0 BRA 0x10 ;"])
    lines += group + [f"        {at(130)}                   STG.E.128 desc[UR4][R2.64], R4 ;",
                      f"        {at(131)}                   BAR.SYNC.DEFER_BLOCKING 0x0 ;",
                      f"        {at(132)}               @P1 BRA 0x0 ;",
                      f"        {at(133)}                   EXIT ;"]
    (line,) = [d for d in (
        {"kernel": name, "instructions": len(ins), **sass.memory_counts(ins),
         "loops": sass.loops(ins)} for name, ins in sass.parse("\n".join(lines)).items())]
    assert (line["instructions"], line["BAR"], line["LDS"], line["STS"]) == (134, 2, 16, 16)
    assert [(lp["instructions"], lp["BAR"]) for lp in line["loops"]] == [(129, 1), (133, 2)]
    groups = sass.ntt_group_bodies(line["kernel"], line["loops"])
    assert groups == [{"log_r": 3, "butterflies": 24, "instructions": 129,
                       "instructions_per_butterfly": 129 / 24}]
    # K = 5 holds one column a thread: 5 stages of 16 butterflies
    one_col = "_ZN12_GLOBAL__N_116ntt_axis0_kernelILi5EEEvNS_4ArgsE"
    assert sass.ntt_group_bodies(one_col, line["loops"])[0]["butterflies"] == 80
    # K = 0 (one row) runs no stages
    assert sass.ntt_group_bodies(one_col.replace("ILi5E", "ILi0E"), line["loops"]) == []
    assert sass.ntt_group_bodies("_Z6kernelPm", line["loops"]) is None
