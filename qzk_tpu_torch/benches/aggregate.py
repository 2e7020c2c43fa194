"""The port's counterpart of benches/bench_aggregator.py: recursive
aggregation of zk Wormhole proofs as a (branching, depth) tree, on one
card.

    python3 -m qzk_tpu_torch.benches.aggregate [b,d ...] [--device cpu]

The default grid is 2,1 2,2 2,3.  As in the reference bench
(aggregator.rs:60-90), one real zk Wormhole proof of
synthetic_circuit_inputs() is proved, and each tree is that proof
padded with the aggregator's dummy proof (generated-bins/, relative to
the working directory: run it from the repository's root), through
``WormholeProofAggregator(...).with_config(...)``.

Chunk circuits go through the aggregator's disk cache in
QZK_CIRCUIT_CACHE_DIR when it is set (``""``: no disk cache), else in a
fresh temporary directory, removed at the end.  So two runs that share
one directory show a cold tree without, then with, the cache.

Per grid point it prints two JSON lines.  ``aggregate_proofs_{b}_{d}``:
the cold seconds (each level's chunk circuit that an earlier grid point
has not made: built on the host, and written to the cache, timed as
``chunk_build_s``, or loaded from the cache, timed as
``chunk_cache_load_s``, with the blobs' bytes as ``chunk_cache_bytes``
and each level's source in ``chunk_sources``; then the first
aggregation, which sets up each chunk circuit's context on the card),
the warm seconds (an immediate re-aggregation, which must give
the same root bytes), the degree bits of each level's chunk circuit,
the chunk count, the peak of ``torch.cuda.max_memory_allocated`` over
both aggregations, the degree bits of the prover contexts left resident
(at most QZK_CTX_LIMIT, 3 by default: the (2, 3) tree's three chunk
levels evict the leaf circuit's), and the card's name and power limit.
``verify_aggregate_proof_{b}_{d}``: the seconds of one host verify of
the root, after a first one.  A root that does not verify, or whose
public inputs do not parse back into the leaves' through
``try_from_aggregated``, ends the run with an error and no line.  ``--device cpu`` runs the plain torch path on the CPU, for tests
only, and the record says so.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

DEFAULT_GRID = [(2, 1), (2, 2), (2, 3)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _parse_point(text: str) -> tuple[int, int]:
    b, d = (int(v) for v in text.split(","))
    if b < 1 or d < 1:
        raise argparse.ArgumentTypeError(f"grid point {text}: branching and depth must be >= 1")
    return b, d


def chunk_levels(common, tree) -> tuple[list, list]:
    """Make (or take from the memo) the chunk circuit of every level of
    `tree` over leaves of `common`.  Returns each level's chunk circuit,
    and for each level [source, seconds, blob bytes]: the source is
    "memo" (made earlier in this process), "disk" (loaded from the disk
    cache) or "build" (built on the host, and written to the disk cache
    when there is one); bytes are the cache blob's, None without one."""
    from ..models.wormhole import aggregator as agg

    levels, made, n = [], [], tree.num_leaf_proofs
    while n > 1 or not levels:
        branching = min(n, tree.tree_branching_factor)
        digest = bytes(np.asarray(common.circuit_digest).tobytes())
        path = agg._chunk_cache_path(digest, branching)
        if (digest, branching) in agg._chunk_circuit_cache:
            source = "memo"
        else:
            source = "disk" if path is not None and path.exists() else "build"
        t0 = time.perf_counter()
        chunk = agg.build_chunk_circuit(common, branching)
        seconds = time.perf_counter() - t0
        nbytes = path.stat().st_size if path is not None and path.exists() else None
        made.append([source, seconds, nbytes])
        levels.append(chunk)
        common = chunk.data.common
        n = -(-n // tree.tree_branching_factor)
    return levels, made


def aggregate_point(verifier_data, leaf_proof, branching: int, depth: int,
                    device: torch.device, where: dict) -> list[dict]:
    """The two records of one grid point."""
    from ..models.wormhole import aggregator as agg
    from ..plonk import device_prover as dp

    tree = agg.TreeAggregationConfig.new(branching, depth)

    def aggregate():
        aggregator = agg.WormholeProofAggregator(verifier_data, device=device).with_config(tree)
        aggregator.push_proof(leaf_proof)
        _sync(device)
        t0 = time.perf_counter()
        root = aggregator.aggregate()
        _sync(device)
        return aggregator, root, time.perf_counter() - t0

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    levels, made = chunk_levels(verifier_data.common, tree)
    build_s = sum(m[1] for m in made if m[0] == "build")
    load_s = sum(m[1] for m in made if m[0] == "disk")
    aggregator, root, first_s = aggregate()
    _, again, warm_s = aggregate()
    if again.proof.to_bytes() != root.proof.to_bytes():
        raise RuntimeError(f"({branching}, {depth}): the warm root differs from the cold one")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    vd = root.circuit_data.verifier_data()
    vd.verify(root.proof)
    t0 = time.perf_counter()
    vd.verify(root.proof)
    verify_s = time.perf_counter() - t0
    parsed = aggregator.extract_leaf_public_inputs(root.proof)
    pis = np.asarray(root.proof.public_inputs, dtype=np.uint64).reshape(len(parsed), -1)
    if not np.array_equal(pis[0], np.asarray(leaf_proof.public_inputs, dtype=np.uint64)):
        raise RuntimeError(f"({branching}, {depth}): the root does not carry the leaf's public inputs")
    return [
        {"metric": f"aggregate_proofs_{branching}_{depth}",
         "value": sum(m[1] for m in made) + first_s, "value_warm": warm_s, "unit": "s",
         "chunk_build_s": build_s, "chunk_cache_load_s": load_s,
         "chunk_cache_bytes": [m[2] for m in made], "chunk_sources": [m[0] for m in made],
         "chunk_cache_dir": os.environ.get("QZK_CIRCUIT_CACHE_DIR"),
         "chunk_degree_bits": [c.data.common.degree_bits for c in levels],
         "chunks": sum(branching ** k for k in range(depth)), "leaves": len(parsed),
         "max_memory_allocated": peak,
         "resident_context_degree_bits": [e[3].degree_bits for e in dp._CTX_LRU],
         "device": str(device), **where},
        {"metric": f"verify_aggregate_proof_{branching}_{depth}", "value": verify_s,
         "unit": "s", "verified": True, "device": str(device), **where},
    ]


def run(grid, device: torch.device):
    """Yields the records of every grid point in turn."""
    from ..models.wormhole.circuit import WormholeCircuit
    from ..models.wormhole.fixtures import synthetic_circuit_inputs
    from ..models.wormhole.prover import WormholeProver
    from ..plonk.config import CircuitConfig
    from .kernels import card

    cfg = CircuitConfig.standard_recursion_zk_config()
    circuit = WormholeCircuit(cfg)
    targets = circuit.targets()
    data = circuit.build_circuit()
    prover = WormholeProver(cfg, _circuit_data=data.prover_data(), _targets=targets,
                            device=device)
    leaf_proof = prover.commit(synthetic_circuit_inputs()).prove()
    where = card() if device.type == "cuda" else {"card": "cpu", "power_limit": None}
    for branching, depth in grid:
        yield from aggregate_point(data.verifier_data(), leaf_proof, branching, depth,
                                   device, where)


def main(argv=None) -> None:
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("grid", nargs="*", type=_parse_point,
                    help="grid points b,d (default: 2,1 2,2 2,3)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    named = "QZK_CIRCUIT_CACHE_DIR" in os.environ
    with tempfile.TemporaryDirectory(prefix="qzk_chunk_cache_") as tmp:
        os.environ.setdefault("QZK_CIRCUIT_CACHE_DIR", tmp)
        try:
            for record in run(args.grid or DEFAULT_GRID, device):
                print(json.dumps(record), flush=True)
        finally:
            if not named:
                del os.environ["QZK_CIRCUIT_CACHE_DIR"]


if __name__ == "__main__":
    main()
