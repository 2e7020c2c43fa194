"""Batches of Wormhole leaf proofs aggregated to one root a request:
each request pushes the batch's leaves into the caller's
WormholeProofAggregator (configured with the configuration's tree) and
calls aggregate(), answered with the root proof's bytes.  With more than
one card the program fans each level's chunks out across them.

Set-up: the leaf circuit (from the benchmark's artifact cache, else built
and written there), the leaf pool drawn from the seed and proved on the
first card, each level's chunk circuit (from the program's disk cache,
which the benchmark keeps in its own cache directory), the batches drawn
from the seed, and one warm-up aggregation, which sets up every chunk
circuit's context on every card the tree uses.
Check: the program's keys (leaf and every level) against the
configuration's, whose bytes the benchmark's tests hold to the JAX
package's; every leaf of the pool read under the leaf key, its public
inputs against its withdrawal's, and verified in full by the plain
reference; and every root read under the top level's key, its public
inputs against its batch's leaves in order, and verified in full."""

from __future__ import annotations

import time

import numpy as np

from harness import program, traffic, work
from reference import formats, verify

BATCHES_DRAWN = 4096


class Runner:
    def __init__(self, cell, seed: int, devices: list, cache_dir: str, trace: bool):
        self.cell, self.seed, self.devices, self.cache_dir = cell, seed, devices, cache_dir
        self.trace = trace
        self.callers = int(cell.traffic["callers"])
        c = cell.config
        self.branching, self.depth = int(c["tree"]["branching"]), int(c["tree"]["depth"])
        self.leaves_per_request = self.branching ** self.depth
        self.keys = c["keys"]
        leaf = self.keys["wormhole"]
        self.leaf_common = formats.read_common(bytes.fromhex(leaf["common"]))
        self.leaf_vk = formats.read_verifier(bytes.fromhex(leaf["verifier"]))
        self.levels = [f"level{i + 1}" for i in range(self.depth)]
        top = self.keys[self.levels[-1]]
        self.top_common = formats.read_common(bytes.fromhex(top["common"]))
        self.top_vk = formats.read_verifier(bytes.fromhex(top["verifier"]))
        self.level_commons = [formats.read_common(bytes.fromhex(self.keys[lv]["common"]))
                              for lv in self.levels]
        self.chunk_proofs: list = []  # (time, public inputs, nonce) of each chunk prove
        self._unwrap = None

    def setup(self, steps) -> None:
        from qzk_tpu_torch.models.wormhole import aggregator as agg

        t = self.cell.traffic
        rng = traffic.rng_of(self.seed)
        self.pool = traffic.withdrawals(rng, int(t["leaf_pool"]), t["withdrawal"])
        self.batches = traffic.batches(rng, len(self.pool), self.leaves_per_request,
                                       BATCHES_DRAWN)
        warm = traffic.batches(rng, len(self.pool), self.leaves_per_request, 1)[0]
        steps.mark("leaf pool")
        self.leaf = program.Wormhole(self.cell.config["circuit"], self.cache_dir)
        steps.mark("leaf circuit")
        self.leaf_proofs = [self.leaf.prove(program.circuit_inputs(w), self.devices[0])
                            for w in self.pool]
        steps.mark("leaf proves")
        tree = agg.TreeAggregationConfig.new(self.branching, self.depth)
        self.chunk_circuits, common = [], self.leaf.data.common
        for level in range(self.depth):
            chunk = agg.build_chunk_circuit(common, self.branching)
            self.chunk_circuits.append(chunk)
            common = chunk.data.common
            steps.mark(f"chunk circuit {level + 1}")
        self.aggregators = [agg.WormholeProofAggregator(self.leaf.data.verifier_data(),
                                                        device=self.devices[0]).with_config(tree)
                            for _ in range(self.callers)]
        self._aggregate(0, warm, None)
        steps.mark("warm-up aggregation")
        if self.trace:
            self._observe_chunks(agg)

    def _observe_chunks(self, agg) -> None:
        """Record each chunk prove's public-input count and nonce, for the
        roofline's work count (only the root reaches the caller); traced
        runs only."""
        prove_chunk = getattr(agg, "_prove_chunk", None)
        if prove_chunk is None:
            return

        def observed(*args, **kwargs):
            out = prove_chunk(*args, **kwargs)
            self.chunk_proofs.append((time.perf_counter(), len(out.proof.public_inputs),
                                      int(out.proof.proof.fri.pow_witness)))
            return out

        agg._prove_chunk = observed
        self._unwrap = lambda: setattr(agg, "_prove_chunk", prove_chunk)

    def _aggregate(self, caller: int, batch: list, marks):
        a = self.aggregators[caller]
        for i in batch:
            a.push_proof(self.leaf_proofs[i])
        # the program times chunk proves one at a time: one card only
        return a.aggregate(timer=marks if len(self.devices) == 1 else None)

    def send(self, caller: int, seq: int, marks) -> bytes:
        return self._aggregate(caller, self.batches[seq], marks).proof.to_bytes()

    def program_keys(self) -> dict:
        keys = {"wormhole": program.key_bytes(self.leaf.data.common,
                                              self.leaf.data.verifier_only)}
        for lv, chunk in zip(self.levels, self.chunk_circuits):
            keys[lv] = program.key_bytes(chunk.data.common, chunk.data.verifier_only)
        return keys

    def close(self) -> None:
        if self._unwrap is not None:
            self._unwrap()
        self.leaf_bytes = [p.to_bytes() for p in self.leaf_proofs]
        self.leaf = self.leaf_proofs = self.chunk_circuits = self.aggregators = None

    def check_leaves(self) -> dict:
        """The pool's leaf proofs against the leaf key and their withdrawals."""
        return check_leaves(self.leaf_common, self.leaf_vk, self.pool, self.leaf_bytes)

    def check(self, window, keys: dict) -> dict:
        answered = [r for r in window.requests if r.error is None]
        bad = {r.seq for r in window.requests if r.error is not None}
        roots, malformed, wrong_pis = [], 0, 0
        for r in answered:
            try:
                p = formats.read_proof(r.answer, self.top_common)
            except formats.FormatError:
                malformed += 1
                bad.add(r.seq)
                continue
            want = np.concatenate([self.pool[i].public_inputs for i in self.batches[r.seq]])
            if not np.array_equal(p.public_inputs, want):
                wrong_pis += 1
                bad.add(r.seq)
            roots.append((r, p))
        reasons = verify.verify_all(self.top_common, self.top_vk, [p for _, p in roots])
        bad |= {r.seq for (r, _), why in zip(roots, reasons) if why is not None}
        keys_differ = sum(keys[k] != self.keys[k] for k in keys)

        by_pis = {c.num_public_inputs: c for c in self.level_commons}
        t0, t1 = window.traced_start, window.traced_end
        traced = [(by_pis[n], nonce) for t, n, nonce in self.chunk_proofs
                  if t0 is not None and t1 is not None and t0 <= t <= t1 and n in by_pis]
        return {
            "checks": {
                "keys_differ": (keys_differ, 0),
                **self.check_leaves(),
                "unanswered": (len(window.requests) - len(answered), 0),
                "malformed": (malformed, 0),
                "wrong_public_inputs": (wrong_pis, 0),
                "invalid_roots": (sum(why is not None for why in reasons), 0),
            },
            "failed_requests": len(bad),
            "verified": len(roots),
            "traced_proofs": len(traced),
            "traced_work": tuple(map(sum, zip(*(work.proof_work(c, w) for c, w in traced))))
            if traced else None,
        }


def check_leaves(common, vk, pool: list, leaf_bytes: list) -> dict:
    """Each leaf proof read under the leaf key, its public inputs against
    its withdrawal's, and verified in full: the compared numbers."""
    proofs, malformed, wrong = [], 0, 0
    for w, blob in zip(pool, leaf_bytes):
        try:
            p = formats.read_proof(blob, common)
        except formats.FormatError:
            malformed += 1
            continue
        wrong += not np.array_equal(p.public_inputs, w.public_inputs)
        proofs.append(p)
    invalid = sum(why is not None for why in verify.verify_batch(common, vk, proofs))
    return {"wrong_leaf_public_inputs": (wrong, 0),
            "invalid_leaves": (malformed + invalid + len(pool) - len(leaf_bytes), 0)}
