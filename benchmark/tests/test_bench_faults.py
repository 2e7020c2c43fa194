"""A run of the wormhole cells with the card's checks skipped and the
program under test replaced by a stand-in that answers with the fixture's
real zk proof: the run is correct when every answer is that proof of that
withdrawal, and `correct` comes out false for each fault the cells can
have (an altered answer, an answer left as it was for another input,
half the answers never coming)."""

import os
import time
import types

import numpy as np
import pytest
import torch

from conftest import DATA, FIXTURE_FIELDS, ROOT
from harness import cell as cell_mod
from harness import spec, traffic
from reference import withdrawal as W

FIXTURE = open(os.path.join(DATA, "wormhole_zk_fixture_proof.bin"), "rb").read()


def template():
    import json

    with open(os.path.join(ROOT, "benchmark", "traffic", "storage_proof_7.json")) as f:
        t = json.load(f)
    return [bytes.fromhex(n) for n in t["nodes"]], t["indices"]


def stand_in(real, pool_fields, answer):
    """A runner module whose Runner keeps the real one's check and
    answers request seq with answer(seq, pool) in place of the program."""

    class Runner(real.Runner):
        def setup(self, steps):
            self.pool = W.build_many(pool_fields, *template())

        def send(self, caller, seq, marks):
            time.sleep(0.05)
            return answer(seq, self.pool)

        def program_keys(self):
            return {"wormhole": self.key}

        def close(self):
            pass

    return types.SimpleNamespace(Runner=Runner)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stand-in")


def flip_query_word(proof: bytes) -> bytes:
    b = bytearray(proof)
    b[-400] ^= 1  # a word of the last query round's FRI path
    return bytes(b)


OTHER = W.Fields(**{**FIXTURE_FIELDS, "exit_account": bytes([5] * 32)})
SOUND = W.Fields(**FIXTURE_FIELDS)

CASES = {
    # name: (pool, answer(seq, pool), correct)
    "sound": ([SOUND], lambda seq, pool: FIXTURE, True),
    "answer_altered": ([SOUND], lambda seq, pool: flip_query_word(FIXTURE), False),
    "state_unchanged": ([SOUND, OTHER], lambda seq, pool: FIXTURE, False),
    "half_left_out": ([SOUND], lambda seq, pool: FIXTURE if seq % 2 == 0 else None, False),
}


def _answer(fn):
    def answer(seq, pool):
        out = fn(seq, pool)
        if out is None:
            raise RuntimeError("no answer")
        return out
    return answer


@pytest.mark.parametrize("workload", ["wormhole_zk.one_caller", "wormhole_zk.four_callers"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_correct_only_when_sound(no_card, workload, case):
    pool, fn, want = CASES[case]
    cell = spec.load_cell(ROOT, workload)
    cell.runner = stand_in(cell.runner, pool, _answer(fn))
    result, lines, _ = cell_mod.run_cell(cell, 7, 0.4, False, time.perf_counter(), "/nonexistent")
    assert result["correct"] is want, (case, result["checks"])
    assert lines[-1].startswith("check ") and list(result)[-1] == "checks"
    if want:
        assert result["failed"] == 0 and result["attempted"] >= 1
        assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
        assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
        assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
        assert {m: set(v) for m, v in result["metrics"].items()} == {
            m.name: {"value", "unit"} for m in cell.end_to_end}
        assert all(set(v) == {"value", "limit"} for v in result["checks"].values())
    else:
        assert result["failed"] >= 1 or not result["correct"]
    assert np.isfinite(result["metrics"]["setup_s"]["value"])


ROOT_SEED = 21
RECORDED_ROOT = open(os.path.join(DATA, "agg_2x3_seed21_batch0_root.bin"), "rb").read()
"""The root the port proved on an H100 for the first batch of seed 21 of
the agg_2x3 cells (leaves 1, 12, 7, 0, 3, 6, 2, 4 of the seed's pool)."""


def agg_stand_in(real, batch_order, answer):
    """A runner module whose Runner keeps the real one's traffic and
    check of the roots, asks request seq for batch batch_order[seq % len]
    of the seed's batches, and answers with answer(seq) in place of the
    program.  It has no leaf proofs of the seed's pool: the check of the
    leaves is held by test_leaf_faults below."""

    class Runner(real.Runner):
        def setup(self, steps):
            rng = traffic.rng_of(self.seed)
            t = self.cell.traffic
            self.pool = traffic.withdrawals(rng, int(t["leaf_pool"]), t["withdrawal"])
            drawn = traffic.batches(rng, len(self.pool), self.leaves_per_request, 2)
            self.batches = [drawn[batch_order[i % len(batch_order)]] for i in range(4096)]

        def check_leaves(self):
            return {"wrong_leaf_public_inputs": (0, 0), "invalid_leaves": (0, 0)}

        def send(self, caller, seq, marks):
            time.sleep(0.2)
            return answer(seq)

        def program_keys(self):
            return dict(self.keys)

        def close(self):
            pass

    return types.SimpleNamespace(Runner=Runner)


def with_half_replaced(root: bytes) -> bytes:
    """The root with its last four leaves' public inputs replaced by the
    first leaf's: a root over half the batch and padding."""
    b = bytearray(root)
    b[64 * 8 : 128 * 8] = b[0 : 16 * 8] * 4
    return bytes(b)


AGG_CASES = {
    "sound": ([0], lambda seq: RECORDED_ROOT, True),
    "answer_altered": ([0], lambda seq: flip_query_word(RECORDED_ROOT), False),
    "state_unchanged": ([0, 1], lambda seq: RECORDED_ROOT, False),
    "half_left_out": ([0], lambda seq: with_half_replaced(RECORDED_ROOT), False),
}


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_agg_correct_only_when_sound(no_card, case):
    order, answer, want = AGG_CASES[case]
    cell = spec.load_cell(ROOT, "agg_2x3.one_card")
    cell.runner = agg_stand_in(cell.runner, order, answer)
    result, lines, _ = cell_mod.run_cell(cell, ROOT_SEED, 0.5, False, time.perf_counter(),
                                      "/nonexistent")
    assert result["correct"] is want, (case, result["checks"])
    assert (result["failed"] == 0) is want and list(result)[-1] == "checks"


LEAF_CASES = {
    # name: (pool, leaf proofs' bytes, (wrong public inputs, invalid leaves))
    "sound": ([SOUND], [FIXTURE], (0, 0)),
    "altered": ([SOUND], [flip_query_word(FIXTURE)], (0, 1)),
    "another_withdrawal": ([OTHER], [FIXTURE], (1, 0)),
    "cut_short": ([SOUND], [FIXTURE[:-8]], (0, 1)),
    "missing": ([SOUND, SOUND], [FIXTURE], (0, 1)),
}


@pytest.mark.parametrize("case", sorted(LEAF_CASES))
def test_leaf_faults(case):
    """The aggregation cells' check of the leaf pool: each leaf proof read
    under the leaf key, its public inputs its withdrawal's, verified in
    full."""
    from runners import aggregation

    pool_fields, blobs, want = LEAF_CASES[case]
    cell = spec.load_cell(ROOT, "agg_2x3.one_card")
    leaf = cell.config["keys"]["wormhole"]
    from reference import formats

    found = aggregation.check_leaves(formats.read_common(bytes.fromhex(leaf["common"])),
                                     formats.read_verifier(bytes.fromhex(leaf["verifier"])),
                                     W.build_many(pool_fields, *template()), blobs)
    assert (found["wrong_leaf_public_inputs"][0], found["invalid_leaves"][0]) == want
