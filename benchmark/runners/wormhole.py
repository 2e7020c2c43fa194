"""Wormhole withdrawals proved one a request: each request is
WormholeProver.commit(inputs).prove() of the next withdrawal of the pool,
answered with the proof's bytes.

Set-up: the circuit (from the benchmark's artifact cache, else built and
written there), the pool of withdrawals drawn from the seed, and two
warm-up proves on the card (the first captures the prove's CUDA graph).
Check: the program's key against the configuration's; every proof read
under that key, its public inputs against the withdrawal's, and verified
in full by the plain reference (transcript, proof-of-work, vanishing
identity, Merkle paths, FRI folds), in processes of its own."""

from __future__ import annotations

import numpy as np

from harness import program, traffic, work
from reference import formats, verify


class Runner:
    leaves_per_request = 1

    def __init__(self, cell, seed: int, devices: list, cache_dir: str, trace: bool):
        self.cell, self.seed, self.devices, self.cache_dir = cell, seed, devices, cache_dir
        self.callers = int(cell.traffic["callers"])
        c = cell.config
        self.key = c["keys"]["wormhole"]
        self.common = formats.read_common(bytes.fromhex(self.key["common"]))
        self.vk = formats.read_verifier(bytes.fromhex(self.key["verifier"]))

    def setup(self, steps) -> None:
        t = self.cell.traffic
        self.pool = traffic.withdrawals(traffic.rng_of(self.seed), int(t["pool"]), t["withdrawal"])
        self.inputs = [program.circuit_inputs(w) for w in self.pool]
        steps.mark("withdrawal pool")
        self.circuit = program.Wormhole(self.cell.config["circuit"], self.cache_dir)
        steps.mark("circuit")
        for i in range(2):
            self.circuit.prove(self.inputs[i], self.devices[0]).to_bytes()
            steps.mark(f"warm-up prove {i + 1}")

    def send(self, caller: int, seq: int, marks) -> bytes:
        proof = self.circuit.prove(self.inputs[seq % len(self.inputs)], self.devices[0], marks)
        return proof.to_bytes()

    def program_keys(self) -> dict:
        d = self.circuit.data
        return {"wormhole": program.key_bytes(d.common, d.verifier_only)}

    def close(self) -> None:
        self.circuit = None
        self.inputs = None

    def check(self, window, keys: dict) -> dict:
        """The compared numbers, each (value, limit), and what the
        roofline reads: the Poseidon work of the traced requests.  `keys`
        are the program's, read before its state was freed."""
        answered = [r for r in window.requests if r.error is None]
        bad = {r.seq for r in window.requests if r.error is not None}
        parsed, malformed, wrong_pis = [], 0, 0
        for r in answered:
            try:
                p = formats.read_proof(r.answer, self.common)
            except formats.FormatError:
                malformed += 1
                bad.add(r.seq)
                continue
            if not np.array_equal(p.public_inputs, self.pool[r.seq % len(self.pool)].public_inputs):
                wrong_pis += 1
                bad.add(r.seq)
            parsed.append((r, p))
        reasons = verify.verify_all(self.common, self.vk, [p for _, p in parsed])
        bad |= {r.seq for (r, _), why in zip(parsed, reasons) if why is not None}

        keys_differ = sum(keys[k] != self.key for k in keys)
        traced = [(self.common, p.pow_witness) for r, p in parsed if r.traced]
        return {
            "checks": {
                "keys_differ": (keys_differ, 0),
                "unanswered": (len(window.requests) - len(answered), 0),
                "malformed": (malformed, 0),
                "wrong_public_inputs": (wrong_pis, 0),
                "failed_pow": (sum(why == verify.FAILED_POW for why in reasons), 0),
                "invalid_proofs": (sum(why is not None for why in reasons), 0),
            },
            "failed_requests": len(bad),
            "verified": len(reasons),
            "traced_proofs": len(traced),
            "traced_work": tuple(map(sum, zip(*(work.proof_work(c, w) for c, w in traced))))
            if traced else None,
        }
