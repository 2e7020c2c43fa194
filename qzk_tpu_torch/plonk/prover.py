"""The prove pipeline (reference analog: ProverCircuitData::prove,
SURVEY.md §3.1 steps 1-5):

  1. run witness generators (levelized batches) -> wire values   (host)
  2. wire polys -> coset LDE -> Merkle-cap commit          } device
  3. permutation Zs + partial products -> LDE -> commit    } (torch +
  4. quotient: evaluate all constraints on the LDE coset,  }  CUDA
     divide by Z_H, split, commit                          }  kernels)
  5. openings at zeta / g*zeta + batched FRI opening proof }

Step 1, the public inputs' hash and the blinding stream's seed are the
prove's host front (prove_front), which makes no CUDA call, so a caller
may make it beforehand, on another thread (the aggregator's one-card
walk does).  Steps 2-5 run in plonk/device_prover.py as one fused
pipeline on the device the caller names: CUDA by default, one CUDA
graph replay a warm prove; the CPU when asked (the same function runs
eagerly, through the plain torch versions of the kernels).  With a mesh active
(qzk_tpu_torch.parallel.set_mesh, or QZK_SHARD=N) of more than one
shard, they run sharded over it
(parallel/prover_sharded.py) when the circuit meets the mesh's
preconditions, else on its first device after a RuntimeWarning; the
mesh's devices then decide where the proof runs.  Under zero knowledge,
the wires, zs and quotient trees commit leaves salted with four columns
each from the witness's blinding stream (blinding_stream), drawn on that
(first) device.

Transcript spec (normative):
  observe circuit digest, observe H(public_inputs);
  observe wires cap -> betas[2], gammas[2];
  observe zs/partial cap -> alphas[2];
  observe quotient cap -> zeta (ext);
  observe openings (preprocessed, wires, zs_partial, quotient,
  zs_partial@g*zeta) -> fri alpha (ext); then FRI (fri.py).
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import poseidon as pos
from ..ops import threefry
from ..utils import spans
from ..utils.device import resolve_device
from .proof import ProofWithPublicInputs
from .witness import run_generators


class PhaseTimer:
    """Time of each prove phase.  With cuda_events=True each mark
    records a CUDA event on the current stream and results() gives the
    device-clock time between marks; otherwise the host clock."""

    def __init__(self, cuda_events: bool = False):
        self._cuda = cuda_events
        self._marks: list = []
        self._start = self._now()

    def _now(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def mark(self, name: str) -> None:
        self._marks.append((name, self._now()))

    def results(self) -> list[tuple[str, float]]:
        """[(phase, ms)] in order."""
        if self._cuda:
            torch.cuda.synchronize()
        out, prev = [], self._start
        for name, t in self._marks:
            ms = prev.elapsed_time(t) if self._cuda else (t - prev) * 1e3
            out.append((name, ms))
            prev = t
        return out


def blinding_seed(values: np.ndarray) -> int:
    """The seed of a witness's zk blinding stream: the first word of
    hash_no_pad over the first 1024 witness values, masked to 63 bits."""
    digest = pos.hash_no_pad(values[: min(len(values), 1024)])
    return int.from_bytes(digest.astype("<u8").tobytes()[:8], "little") & 0x7FFFFFFFFFFFFFFF


def blinding_stream(seed: int, device):
    """The zk blinding stream of a witness whose blinding_seed is `seed`:
    a function shape -> the next draw, an int64 tensor of canonical
    field elements on `device`.

    Each draw splits the key once and takes
    jax.random.bits(sub, shape, "uint64") >> 1, bit for bit
    (ops/threefry.py).  The draw order is part of the stream."""
    blind_key = threefry.prng_key(seed)

    def _blind_bits(shape):
        nonlocal blind_key
        with spans.span("blinding.draw"):
            blind_key, sub = threefry.split(blind_key)
            return threefry.random_bits_u64_shr1(sub, shape, device)

    return _blind_bits


@dataclass(frozen=True)
class Front:
    """The host front of a prove, which makes no CUDA call: the witness
    values (by union-find root), the public inputs, their hash, and the
    blinding stream's seed (None without zero knowledge)."""

    values: np.ndarray
    public_inputs: np.ndarray
    pi_hash: np.ndarray
    blind_seed: int | None


def prove_front(common, prover_only, pw, phases=None) -> Front:
    """The front of a prove of the partial witness `pw`: the generators,
    then (after `phases` marks "witness", when given) the public inputs,
    their hash and the blinding seed."""
    values, _known = run_generators(prover_only.plan, pw)
    if phases is not None:
        phases.mark("witness")
    public_inputs = values[
        prover_only.plan.roots[
            np.asarray(prover_only.public_inputs, dtype=np.int64)
        ]
    ] if prover_only.public_inputs else np.zeros(0, dtype=np.uint64)
    pi_hash = pos.hash_no_pad(public_inputs)
    seed = blinding_seed(values) if common.config.zero_knowledge else None
    return Front(values, public_inputs, pi_hash, seed)


def prove(common, prover_only, pw, device=None, timer: PhaseTimer | None = None,
          front: Front | None = None) -> ProofWithPublicInputs:
    """Prove the circuit for the partial witness `pw` on `device`
    (CUDA unless the caller passes "cpu"), or over the active mesh.
    With a `timer`, or inside an open request, the prove is the span
    "prove" (utils/spans.py) and its phases are spans that end where
    `timer` is marked.  `front`: the prove's front (prove_front), when
    the caller made it beforehand; `pw` is then not read and the phase
    "witness" ends as the prove starts."""
    from .. import parallel as _parallel

    mesh = _parallel.active_mesh()
    dev = resolve_device(device) if mesh is None else _mesh_device(mesh, device)
    with spans.span("prove", timer=timer, card=dev) as phases:
        if front is None:
            front = prove_front(common, prover_only, pw, phases)
        elif phases is not None:
            phases.mark("witness")
        return _prove(common, prover_only, front, dev, mesh, phases)


def _prove(common, prover_only, front: Front, dev, mesh, phases) -> ProofWithPublicInputs:
    """The device part of prove() on `dev` (the mesh's first device
    under a mesh), from the prove's front: the blinding draws, then the
    pipeline; `phases` marks the prove's phases (None: nothing is
    recorded)."""
    cfg = common.config
    N = common.degree
    values, public_inputs, pi_hash = front.values, front.public_inputs, front.pi_hash

    _blind_bits = blinding_stream(front.blind_seed, dev) if cfg.zero_knowledge else None
    n_used = len(prover_only.rows)
    blind_block = None  # blinds unconstrained padding rows
    if cfg.zero_knowledge and n_used < N:
        # the first split, before any fresh_salt (the split order is
        # part of the deterministic blinding stream)
        blind_block = _blind_bits((N - n_used, cfg.num_wires))
    if phases is not None and cfg.zero_knowledge:
        phases.mark("blinding")

    def fresh_salt(n_leaves):
        """(n_leaves, 4) blinding salt on the prove device, or None
        without zero knowledge."""
        if not cfg.zero_knowledge:
            return None
        return _blind_bits((n_leaves, 4))

    if mesh is not None and mesh.size > 1:
        from ..parallel.prover_sharded import mesh_preconditions_ok, sharded_prove

        if mesh_preconditions_ok(common, mesh):
            return sharded_prove(
                common, prover_only, values, blind_block, public_inputs, pi_hash,
                fresh_salt, phases, mesh,
            )
        warnings.warn(
            f"circuit (degree {N}) does not satisfy the sharded-prove "
            f"divisibility preconditions for a {mesh.size}-device "
            "mesh; falling back to the single-device pipeline",
            RuntimeWarning,
            stacklevel=3,
        )

    from .device_prover import device_prove

    return device_prove(
        common, prover_only, values, blind_block, public_inputs, pi_hash,
        fresh_salt, dev, phases,
    )


def _mesh_device(mesh, device) -> torch.device:
    """The device a prove over `mesh` runs its single-device work on (the
    first shard's); `device`, when given, must be one of the mesh's."""
    if device is None:
        return mesh.devices[0]
    from .device_prover import context_device

    dev = context_device(resolve_device(device))
    if dev not in mesh.devices:
        raise ValueError(f"device {dev} is not a device of the active mesh {mesh}")
    return mesh.devices[0]
