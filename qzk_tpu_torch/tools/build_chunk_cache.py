"""Pre-build and disk-cache every recursion chunk-circuit shape needed
for the reference aggregation bench grid (aggregator/benches/
aggregator.rs:179-202: (2,1)..(2,5),(3,2)..(7,2)), the JAX package's
tools/build_chunk_cache.py on the port.

A (branching=b, depth=d) tree needs one chunk-circuit shape per level:
level 1 verifies b wormhole proofs; level l>=2 verifies b proofs of the
level-(l-1) chunk circuit.  Each shape depends only on the CHILD
circuit's common data, so the whole chain builds without proving
anything — build level l, feed its common into level l+1.

The zk Wormhole circuit, the chain's first child, is built here (a few
seconds of host Python).  The JAX package's .cache/wormhole_circuit_zk.bin
is not read: it pickles qzk_tpu classes.  Each level goes to the port's
chunk cache (models/wormhole/aggregator.py: QZK_CIRCUIT_CACHE_DIR, by
default .cache/chunk_circuits_torch under the working directory), from
which aggregate() and benches/aggregate.py then load it.  No card is
needed.

Usage:
    python -m qzk_tpu_torch.tools.build_chunk_cache [b:maxdepth ...]
defaults to the full reference grid: 2:5 3:2 4:2 5:2 6:2 7:2
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

DEFAULT_CHAINS = [(2, 5), (3, 2), (4, 2), (5, 2), (6, 2), (7, 2)]


def emit(metric, value, unit="s", **kw):
    print(json.dumps({"metric": metric, "value": value, "unit": unit, **kw}), flush=True)


def parse_chain(text: str) -> tuple[int, int]:
    b, d = (int(x) for x in text.split(":"))
    if b < 1 or d < 1:
        raise ValueError(f"chain {text}: branching and depth must be >= 1")
    return b, d


def main(argv=None) -> None:
    from ..models.wormhole import aggregator as agg_mod
    from ..models.wormhole.circuit import WormholeCircuit
    from ..plonk.config import CircuitConfig

    args = sys.argv[1:] if argv is None else argv
    chains = [parse_chain(a) for a in args] if args else DEFAULT_CHAINS

    t0 = time.perf_counter()
    leaf_common = WormholeCircuit(CircuitConfig.standard_recursion_zk_config()).build_verifier().common
    emit("wormhole_zk_circuit_build", time.perf_counter() - t0)

    for b, maxd in chains:
        common = leaf_common
        for level in range(1, maxd + 1):
            digest = bytes(np.asarray(common.circuit_digest).tobytes())
            path = agg_mod._chunk_cache_path(digest, b)
            t0 = time.perf_counter()
            hit = path is not None and path.exists()
            circuit = agg_mod.build_chunk_circuit(common, b)
            emit(
                "chunk_circuit_cache_hit" if hit else "chunk_circuit_build",
                time.perf_counter() - t0,
                branching=b,
                level=level,
                degree_bits=circuit.data.common.degree_bits,
                path=None if path is None else str(path),
            )
            common = circuit.data.common
            # bound RAM: each built circuit holds its full LDE (~0.1-1 GB)
            agg_mod._chunk_circuit_cache.clear()
    print("chunk-circuit cache populated", flush=True)


if __name__ == "__main__":
    main()
