"""The port's aggregator (qzk_tpu_torch/models/wormhole/aggregator.py)
and its per-device context cache (plonk/device_prover.get_context):
the chunk circuit over the zk Wormhole at branching 2 equals the JAX
package's, the fast tier of tests/test_aggregator.py holds against the
port's module, the context LRU evicts and keys by the device with its
index, the chunk fan-out runs in order, and the aggregator's dummy proof
loads, verifies and re-serializes.  The chunk-circuit disk cache round
trips the square chunk circuit, reloads it with no host build, writes
nothing under QZK_CIRCUIT_CACHE_DIR="", and keeps its slot apart from
the JAX package's.  The JAX pin of the (2, 1) root is in
tests/test_torch_aggregate_pin.py, a file of its own for its minutes of
JAX prove.  Every test here runs with QZK_CIRCUIT_CACHE_DIR in a
temporary directory, so that nothing is written into the checkout."""

import hashlib
import os
import threading

import numpy as np
import pytest
import torch

from qzk_tpu.models.wormhole import aggregator as jagg
from qzk_tpu.models.wormhole.circuit import WormholeCircuit as JCircuit
from qzk_tpu.plonk.config import CircuitConfig as JConfig
from qzk_tpu.utils import serialization as jser
from qzk_tpu.utils.serialization import common_to_bytes
from qzk_tpu_torch.models.wormhole import aggregator as tagg
from qzk_tpu_torch.models.wormhole import fixtures as tfix
from qzk_tpu_torch.models.wormhole.aggregator import (
    TreeAggregationConfig,
    WormholeProofAggregator,
    aggregate_level,
    aggregate_to_tree,
    pad_with_dummy_proofs,
)
from qzk_tpu_torch.models.wormhole.circuit import WormholeCircuit as TCircuit
from qzk_tpu_torch.models.wormhole.inputs import PublicCircuitInputs
from qzk_tpu_torch.models.wormhole.prover import WormholeProver as TProver
from qzk_tpu_torch.plonk import device_prover as dp
from qzk_tpu_torch.plonk.config import CircuitConfig as TConfig
from qzk_tpu_torch.utils import codec
from qzk_tpu_torch.utils import serialization as tser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def _chunk_cache_in_a_temporary_directory(tmp_path_factory):
    """The port's build_chunk_circuit writes its disk cache under
    QZK_CIRCUIT_CACHE_DIR: keep it out of the checkout."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("QZK_CIRCUIT_CACHE_DIR", str(tmp_path_factory.mktemp("chunk_cache")))
        yield


@pytest.fixture(scope="module")
def torch_zk():
    c = TCircuit(TConfig.standard_recursion_zk_config())
    return c.build_circuit(), c.targets()


@pytest.fixture(scope="module")
def jax_zk_common():
    return JCircuit(JConfig.standard_recursion_zk_config()).build_circuit().common


@pytest.fixture(scope="module")
def chunks_2_1(torch_zk, jax_zk_common):
    """The (2, 1) tree's chunk circuit, built by each package."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("QZK_CIRCUIT_CACHE_DIR", "")
        jc = jagg._build_chunk_circuit_uncached(jax_zk_common, 2)
    return jc, tagg._build_chunk_circuit_uncached(torch_zk[0].common, 2)


def test_wormhole_chunk_circuit_at_branching_2_matches(chunks_2_1):
    jc, tc = chunks_2_1
    jcom, tcom = jc.data.common, tc.data.common
    assert tcom.degree_bits == jcom.degree_bits == 15
    assert tcom.config.zero_knowledge
    assert (tcom.circuit_digest == jcom.circuit_digest).all()
    assert (
        tc.data.verifier_only.constants_sigmas_cap
        == jc.data.verifier_only.constants_sigmas_cap
    ).all()
    assert [repr(g) for g in tcom.gates] == [repr(g) for g in jcom.gates]
    assert common_to_bytes(tcom) == common_to_bytes(jcom)
    assert len(tc.data.prover_only.rows) == len(jc.data.prover_only.rows)
    assert tcom.num_public_inputs == 32


def test_wormhole_chunk_circuit_serialized_bytes_match(chunks_2_1):
    jc, tc = chunks_2_1
    assert tser.common_to_bytes(tc.data.common) == jser.common_to_bytes(jc.data.common)
    assert tser.verifier_only_to_bytes(tc.data.verifier_only) == jser.verifier_only_to_bytes(
        jc.data.verifier_only)


# -- the fast tier of tests/test_aggregator.py, on the port -----------------


class TestTreeAggregationConfig:
    def test_num_leaf_proofs(self):
        cfg = TreeAggregationConfig.new(2, 3)
        assert cfg.num_leaf_proofs == 8
        assert TreeAggregationConfig.new(3, 2).num_leaf_proofs == 9

    def test_default_shape(self):
        cfg = TreeAggregationConfig.default()
        assert (cfg.tree_branching_factor, cfg.tree_depth) == (2, 3)
        assert cfg.num_leaf_proofs == 8


class TestPadding:
    def test_too_many_proofs_rejected(self):
        with pytest.raises(ValueError, match="more than the maximum"):
            pad_with_dummy_proofs([1, 2, 3], 2, None)

    def test_missing_dummy_rejected(self):
        with pytest.raises(ValueError, match="no dummy proof"):
            pad_with_dummy_proofs([1], 4, None)

    def test_pads_to_length(self):
        assert pad_with_dummy_proofs([1], 4, "dummy") == [1, "dummy", "dummy", "dummy"]

    def test_full_buffer_unchanged(self):
        assert pad_with_dummy_proofs([1, 2], 2, None) == [1, 2]

    def test_push_beyond_the_buffer_rejected(self):
        agg = WormholeProofAggregator(None, TreeAggregationConfig.new(2, 1), device="cpu")
        agg.push_proof("a")
        agg.push_proof("b")
        with pytest.raises(ValueError, match="buffer is full"):
            agg.push_proof("c")


class _FakeProof:
    def __init__(self, pis):
        self.public_inputs = np.asarray(pis, dtype=np.uint64)


class TestAggregatedPiParsing:
    def test_try_from_aggregated_roundtrip(self):
        leaf = []
        for k in range(2):
            nullifier = np.arange(4, dtype=np.uint64) + k
            root = np.arange(4, dtype=np.uint64) + 10 + k
            amount = codec.u128_to_felts(10**12 + k)
            exit_acct = np.arange(4, dtype=np.uint64) + 20 + k
            leaf.append(np.concatenate([nullifier, root, amount, exit_acct]))
        parsed = PublicCircuitInputs.try_from_aggregated(
            _FakeProof(np.concatenate(leaf)), 16, 2
        )
        assert len(parsed) == 2
        assert parsed[0].funding_amount == 10**12
        assert parsed[1].funding_amount == 10**12 + 1

    def test_wrong_length_rejected(self):
        with pytest.raises(ValueError, match="aggregated public inputs"):
            PublicCircuitInputs.try_from_aggregated(
                _FakeProof(np.zeros(17, dtype=np.uint64)), 16, 2
            )


@pytest.fixture(scope="module")
def square_chunk(tmp_path_factory):
    """The square test circuit and its branching-1 chunk circuit, made
    twice through build_chunk_circuit (a fresh memo, the disk cache in a
    fresh directory); the host builds are counted."""
    cache = tmp_path_factory.mktemp("square_chunk_cache")
    calls = []
    real = tagg._build_chunk_circuit_uncached
    data, _ = tfix.square_circuit(TConfig.standard_recursion_config())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("QZK_CIRCUIT_CACHE_DIR", str(cache))
        mp.setattr(tagg, "_chunk_circuit_cache", {})
        mp.setattr(tagg, "_build_chunk_circuit_uncached",
                   lambda common, branching: calls.append(branching) or real(common, branching))
        a = tagg.build_chunk_circuit(data.common, 1)
        b = tagg.build_chunk_circuit(data.common, 1)
        memo = dict(tagg._chunk_circuit_cache)
        path = tagg._chunk_cache_path(bytes(np.asarray(data.common.circuit_digest).tobytes()), 1)
    return {"data": data, "first": a, "second": b, "calls": calls, "memo": memo,
            "cache": cache, "path": path}


def test_chunk_circuit_memoized_per_digest_and_branching(square_chunk):
    data, a, b = square_chunk["data"], square_chunk["first"], square_chunk["second"]
    assert a is b and square_chunk["calls"] == [1]
    key = (bytes(np.asarray(data.common.circuit_digest).tobytes()), 1)
    assert square_chunk["memo"][key] is a
    assert (key[0], 2) not in square_chunk["memo"]


def _prover_arrays(po):
    return {name: getattr(po, name) for name in (
        "slot_rows", "slot_cols", "slot_targets", "preprocessed_values",
        "preprocessed_lde", "sigma_encodings")}


def test_chunk_cache_round_trip(square_chunk):
    path, built = square_chunk["path"], square_chunk["first"]
    assert path.parent == square_chunk["cache"]
    assert os.listdir(square_chunk["cache"]) == [path.name]
    blob = path.read_bytes()
    assert blob[:5] == tagg._MAGIC_CHUNK
    loaded = tagg._chunk_circuit_from_bytes(blob)
    assert tser.common_to_bytes(loaded.data.common) == tser.common_to_bytes(built.data.common)
    assert tser.verifier_only_to_bytes(loaded.data.verifier_only) == (
        tser.verifier_only_to_bytes(built.data.verifier_only))
    got, want = _prover_arrays(loaded.data.prover_only), _prover_arrays(built.data.prover_only)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    assert len(loaded.data.prover_only.rows) == len(built.data.prover_only.rows)
    assert np.array_equal(loaded.data.prover_only.preprocessed_tree.cap,
                          built.data.prover_only.preprocessed_tree.cap)
    assert len(loaded.proof_targets) == len(built.proof_targets) == 1


def test_chunk_cache_reload_runs_no_host_build(square_chunk, monkeypatch):
    monkeypatch.setenv("QZK_CIRCUIT_CACHE_DIR", str(square_chunk["cache"]))
    monkeypatch.setattr(tagg, "_chunk_circuit_cache", {})

    def no_build(common, branching):
        raise AssertionError("the chunk circuit was built, not loaded from the disk cache")

    monkeypatch.setattr(tagg, "_build_chunk_circuit_uncached", no_build)
    data = square_chunk["data"]
    loaded = tagg.build_chunk_circuit(data.common, 1)
    assert loaded is not square_chunk["first"]
    assert (loaded.data.common.circuit_digest == square_chunk["first"].data.common.circuit_digest).all()
    assert tagg.build_chunk_circuit(data.common, 1) is loaded


def test_empty_cache_dir_writes_nothing(square_chunk, tmp_path, monkeypatch):
    monkeypatch.setenv("QZK_CIRCUIT_CACHE_DIR", "")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tagg, "_chunk_circuit_cache", {})
    calls = []
    monkeypatch.setattr(tagg, "_build_chunk_circuit_uncached",
                        lambda common, branching: calls.append(branching) or square_chunk["first"])
    data = square_chunk["data"]
    assert tagg._chunk_cache_path(b"\x00" * 32, 1) is None
    assert tagg.build_chunk_circuit(data.common, 1) is square_chunk["first"]
    assert calls == [1] and os.listdir(tmp_path) == []


def test_chunk_cache_slot_is_not_the_jax_packages(square_chunk, monkeypatch):
    digest = bytes(np.asarray(square_chunk["data"].common.circuit_digest).tobytes())
    monkeypatch.delenv("QZK_CIRCUIT_CACHE_DIR")
    tpath, jpath = tagg._chunk_cache_path(digest, 2), jagg._chunk_cache_path(digest, 2)
    assert tpath.parent != jpath.parent and tpath.name != jpath.name
    assert str(tpath.parent) == os.path.join(".cache", "chunk_circuits_torch")
    monkeypatch.setenv("QZK_CIRCUIT_CACHE_DIR", str(square_chunk["cache"]))
    tpath, jpath = tagg._chunk_cache_path(digest, 2), jagg._chunk_cache_path(digest, 2)
    assert tpath.parent == jpath.parent and tpath.name != jpath.name
    assert tagg._MAGIC_CHUNK != jagg._MAGIC_CHUNK
    with pytest.raises(ValueError, match="bad chunk-circuit cache blob"):
        jagg._chunk_circuit_from_bytes(square_chunk["path"].read_bytes())


def test_chunk_cache_blob_leaves_the_context_out(square_chunk, monkeypatch):
    """A chunk circuit that has proved holds its context on the prover
    data; the cache blob is the same as before."""
    built = square_chunk["first"]
    before = tagg._chunk_circuit_to_bytes(built)
    monkeypatch.setattr(built.data.prover_only, "_torch_ctxs", {"cpu": object()}, raising=False)
    assert tagg._chunk_circuit_to_bytes(built) == before


def test_chunk_cache_write_leaves_no_temporary_file(square_chunk, tmp_path):
    path = tmp_path / "sub" / "chunk.bin"
    nbytes = tagg._write_chunk_cache(path, square_chunk["first"])
    assert nbytes == path.stat().st_size
    assert os.listdir(tmp_path / "sub") == ["chunk.bin"]


# -- the per-device context cache --------------------------------------------


def _small_circuits(n):
    """n distinct small circuits (x^k for k = 2..n+1)."""
    from qzk_tpu_torch.plonk.builder import CircuitBuilder

    out = []
    for k in range(2, n + 2):
        builder = CircuitBuilder(TConfig.standard_recursion_config())
        x = builder.add_virtual_target()
        y = x
        for _ in range(k - 1):
            y = builder.mul(y, x)
        builder.register_public_input(y)
        out.append(builder.build())
    return out


def test_context_lru_evicts_the_least_recently_used(monkeypatch):
    monkeypatch.setenv("QZK_CTX_LIMIT", "2")
    monkeypatch.setattr(dp, "_CTX_LRU", [])
    a, b, c = _small_circuits(3)
    ctx_a = dp.get_context(a.common, a.prover_only, "cpu")
    dp.get_context(b.common, b.prover_only, "cpu")
    # touch a: b is now the least recently used
    assert dp.get_context(a.common, a.prover_only, "cpu") is ctx_a
    dp.get_context(c.common, c.prover_only, "cpu")
    assert list(a.prover_only._torch_ctxs) == ["cpu"]
    assert b.prover_only._torch_ctxs == {}
    assert list(c.prover_only._torch_ctxs) == ["cpu"]
    assert len(dp._CTX_LRU) == 2
    assert dp.get_context(a.common, a.prover_only, "cpu") is ctx_a


def test_ctx_limit_reads_the_environment(monkeypatch):
    monkeypatch.delenv("QZK_CTX_LIMIT", raising=False)
    assert dp._ctx_limit() == 3
    monkeypatch.setenv("QZK_CTX_LIMIT", "5")
    assert dp._ctx_limit() == 5
    monkeypatch.setenv("QZK_CTX_LIMIT", "0")
    assert dp._ctx_limit() == 1
    monkeypatch.setenv("QZK_CTX_LIMIT", "many")
    assert dp._ctx_limit() == 3


class _StubContext:
    built: list = []

    def __init__(self, common, prover_only, device):
        self.device = device
        _StubContext.built.append(device)


def test_cuda_and_cuda_0_share_one_context(monkeypatch):
    """A bare "cuda" is keyed as the current card (no card needed: the
    current device and the context are stubbed)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert dp.context_device("cuda") == dp.context_device("cuda:0") == torch.device("cuda", 0)
    assert dp.context_device("cuda:1") == torch.device("cuda", 1)
    assert dp.context_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(dp, "DeviceProverContext", _StubContext)
    monkeypatch.setattr(dp, "_CTX_LRU", [])
    monkeypatch.setattr(_StubContext, "built", [])
    (data,) = _small_circuits(1)
    one = dp.get_context(data.common, data.prover_only, "cuda")
    assert dp.get_context(data.common, data.prover_only, "cuda:0") is one
    assert dp.get_context(data.common, data.prover_only, torch.device("cuda", 0)) is one
    assert _StubContext.built == [torch.device("cuda", 0)]
    assert list(data.prover_only._torch_ctxs) == ["cuda:0"]


def test_out_of_memory_evicts_every_context_and_retries_once(monkeypatch):
    monkeypatch.setenv("QZK_CTX_LIMIT", "3")
    monkeypatch.setattr(dp, "_CTX_LRU", [])
    a, b = _small_circuits(2)
    dp.get_context(a.common, a.prover_only, "cpu")
    attempts = []
    real = dp.DeviceProverContext

    def flaky(common, prover_only, device):
        attempts.append(device)
        if len(attempts) == 1:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return real(common, prover_only, device)

    monkeypatch.setattr(dp, "DeviceProverContext", flaky)
    ctx = dp.get_context(b.common, b.prover_only, "cpu")
    assert attempts == [torch.device("cpu")] * 2
    assert a.prover_only._torch_ctxs == {}
    assert b.prover_only._torch_ctxs == {"cpu": ctx}
    # a second failure is not caught
    attempts.clear()
    monkeypatch.setattr(
        dp, "DeviceProverContext",
        lambda *args: (_ for _ in ()).throw(torch.cuda.OutOfMemoryError("oom")),
    )
    with pytest.raises(torch.cuda.OutOfMemoryError):
        dp.get_context(a.common, a.prover_only, "cpu")


# -- the chunk fan-out ----------------------------------------------------------


def test_agg_workers(monkeypatch):
    monkeypatch.delenv("QZK_AGG_WORKERS", raising=False)
    cpu = torch.device("cpu")
    assert tagg._agg_workers(4, cpu) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tagg._agg_workers(2, torch.device("cuda", 0)) == 2
    assert tagg._agg_workers(8, torch.device("cuda", 0)) == 4
    monkeypatch.setenv("QZK_AGG_WORKERS", "3")
    assert tagg._agg_workers(8, cpu) == 3
    assert tagg._agg_workers(2, cpu) == 2
    monkeypatch.setenv("QZK_AGG_WORKERS", "0")
    assert tagg._agg_workers(8, cpu) == 1
    assert [str(d) for d in tagg._chunk_devices(6, torch.device("cuda", 0))] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3", "cuda:0", "cuda:1"]
    assert tagg._chunk_devices(2, cpu) == [cpu, cpu]


def test_threaded_level_returns_chunks_in_order(monkeypatch):
    monkeypatch.setenv("QZK_AGG_WORKERS", "2")
    monkeypatch.setattr(tagg, "build_chunk_circuit", lambda common, size: f"circuit/{size}")
    seen = []
    lock = threading.Lock()
    release = threading.Barrier(2, timeout=30)

    def stub(circuit, chunk, verifier_only, device=None, timer=None, front=None):
        assert front is None  # a chunk that fans out makes its own front
        with lock:
            seen.append((threading.current_thread().name, tuple(chunk), device))
        if chunk[0] < 4:
            release.wait()  # the first two chunks run at once
        return (circuit, tuple(chunk), verifier_only)

    monkeypatch.setattr(tagg, "_prove_chunk", stub)
    out = aggregate_level(
        list(range(5)), "common", "vo", TreeAggregationConfig.new(2, 2), device="cpu"
    )
    assert out == [
        ("circuit/2", (0, 1), "vo"), ("circuit/2", (2, 3), "vo"), ("circuit/1", (4,), "vo")]
    assert len({name for name, _, _ in seen}) == 2
    assert all(d == torch.device("cpu") for _, _, d in seen)
    assert threading.main_thread().name not in {name for name, _, _ in seen}


def test_tree_runs_level_by_level(monkeypatch):
    """aggregate_to_tree: each level's chunks prove the previous level's
    proofs against that level's circuit data, down to one root."""
    monkeypatch.delenv("QZK_AGG_WORKERS", raising=False)
    monkeypatch.setattr(tagg, "build_chunk_circuit", lambda common, size: (common, size))

    class _Data:
        def __init__(self, level):
            self.common, self.verifier_only = f"common{level}", f"vo{level}"

    def stub(circuit, chunk, verifier_only, device=None, timer=None, front=None):
        level = int(circuit[0][-1]) + 1
        assert front == ("front", circuit, tuple(chunk), verifier_only)
        return tagg.AggregatedProof(proof=("p", level, tuple(chunk)), circuit_data=_Data(level))

    monkeypatch.setattr(tagg, "_prove_chunk", stub)
    monkeypatch.setattr(tagg, "_chunk_front",
                        lambda circuit, chunk, vo: ("front", circuit, tuple(chunk), vo))
    root = aggregate_to_tree(
        list(range(8)), "common0", "vo0", TreeAggregationConfig.new(2, 3), device="cpu")
    assert root.circuit_data.common == "common3"
    assert root.proof[:2] == ("p", 3)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tagg, "_prove_chunk", lambda *a, **k: pytest.fail("proved"))
    cfg = TreeAggregationConfig.new(2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aggregate_level([1, 2], "common", "vo", cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aggregate_to_tree([1, 2], "common", "vo", cfg)
    agg = WormholeProofAggregator(None, cfg, dummy_proof="dummy")
    agg.push_proof("leaf")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        agg.aggregate()


def test_dummy_proof_loads_verifies_and_reserializes(torch_zk, monkeypatch):
    data = torch_zk[0]
    monkeypatch.chdir(ROOT)
    agg = WormholeProofAggregator(data.verifier_data(), device="cpu")
    dummy = agg._load_dummy_proof()
    assert dummy is not None
    data.verifier_data().verify(dummy)
    blob = open(os.path.join(ROOT, "generated-bins", "dummy_proof_zk.bin"), "rb").read()
    assert dummy.to_bytes() == blob
    assert len(agg.extract_leaf_public_inputs(_FakeProof(
        np.tile(np.asarray(dummy.public_inputs), 8)))) == 8


@pytest.mark.skipif(
    os.environ.get("QZK_SLOW_TESTS") != "1",
    reason="the port's zk Wormhole proves and chunk prove on the CPU take minutes; "
    "set QZK_SLOW_TESTS=1",
)
def test_port_aggregation_on_cpu_matches_pinned_hash(torch_zk):
    data, targets = torch_zk
    cfg = TConfig.standard_recursion_zk_config()
    leaves = [
        TProver(cfg, _circuit_data=data.prover_data(), _targets=targets, device="cpu")
        .commit(inputs).prove()
        for inputs in tfix.aggregation_leaf_inputs()
    ]
    root = aggregate_to_tree(
        leaves, data.common, data.verifier_only, TreeAggregationConfig.new(2, 1), device="cpu")
    assert hashlib.sha256(root.proof.to_bytes()).hexdigest() == tfix.AGG_2_1_ZK_ROOT_SHA256
    root.circuit_data.verify(root.proof)
    parsed = PublicCircuitInputs.try_from_aggregated(root.proof, 16, 2)
    assert [bytes(p.exit_account) for p in parsed] == [bytes([4] * 32), bytes([5] * 32)]


# -- benches/aggregate.py ---------------------------------------------------------


class _StubCommon:
    def __init__(self, level):
        self.level = level
        self.degree_bits = 13 + 2 * min(level, 1)
        self.num_public_inputs = 16
        # the bench looks for each level's slot in the disk cache
        self.circuit_digest = np.array([level, 0, 0, 0], dtype=np.uint64)


class _StubData:
    def __init__(self, level):
        self.common = _StubCommon(level)
        self.verifier_only = f"vo{level}"

    def verifier_data(self):
        return self

    def verify(self, proof):
        assert proof.public_inputs.shape == (16 * 2 ** self.common.level,)


def _stub_aggregation(monkeypatch):
    """Chunk circuits and proves that only concatenate public inputs."""
    built = []

    def build(common, size):
        built.append((common.level, size))
        return tagg._ChunkCircuit(data=_StubData(common.level + 1),
                                  verifier_data_target=None, proof_targets=[None] * size)

    def front(circuit, chunk, verifier_only):
        return np.concatenate([np.asarray(p.public_inputs, dtype=np.uint64) for p in chunk])

    def prove(circuit, chunk, verifier_only, device=None, timer=None, front=None):
        pis = np.concatenate([np.asarray(p.public_inputs, dtype=np.uint64) for p in chunk])
        assert front is None or np.array_equal(front, pis)
        return tagg.AggregatedProof(proof=_StubProof(pis), circuit_data=circuit.data)

    monkeypatch.setattr(tagg, "build_chunk_circuit", build)
    monkeypatch.setattr(tagg, "_chunk_front", front)
    monkeypatch.setattr(tagg, "_prove_chunk", prove)
    return built


class _StubProof:
    def __init__(self, pis):
        self.public_inputs = pis

    def to_bytes(self):
        return self.public_inputs.tobytes()


def test_bench_aggregate_point_on_stubbed_proves(monkeypatch):
    from qzk_tpu_torch.benches import aggregate as bench

    built = _stub_aggregation(monkeypatch)
    leaf = _StubProof(np.arange(16, dtype=np.uint64) + 1)
    dummy = _StubProof(np.zeros(16, dtype=np.uint64))
    monkeypatch.setattr(tagg.WormholeProofAggregator, "_load_dummy_proof", lambda self: dummy)
    agg_rec, ver_rec = bench.aggregate_point(
        _StubData(0), leaf, 2, 3, torch.device("cpu"), {"card": "cpu", "power_limit": None})
    assert agg_rec["metric"] == "aggregate_proofs_2_3"
    assert agg_rec["chunk_degree_bits"] == [15, 15, 15]
    assert agg_rec["chunks"] == 7 and agg_rec["leaves"] == 8
    assert agg_rec["max_memory_allocated"] is None and agg_rec["device"] == "cpu"
    assert ver_rec["metric"] == "verify_aggregate_proof_2_3" and ver_rec["verified"]
    assert agg_rec["value"] >= agg_rec["chunk_build_s"] >= 0 and agg_rec["value_warm"] >= 0
    assert agg_rec["chunk_sources"] == ["build"] * 3 and agg_rec["chunk_cache_load_s"] == 0
    assert agg_rec["chunk_cache_bytes"] == [None] * 3
    # chunk_levels takes levels 0, 1, 2, then each aggregation takes one
    # circuit a level for its 4 + 2 + 1 chunks
    assert built == [(0, 2), (1, 2), (2, 2)] * 3


def test_bench_reports_where_each_chunk_circuit_came_from(monkeypatch, tmp_path):
    """chunk_levels: a level's circuit is built (and written to the
    cache), loaded from the cache, or taken from the memo."""
    from qzk_tpu_torch.benches import aggregate as bench

    monkeypatch.setenv("QZK_CIRCUIT_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(tagg, "_chunk_circuit_cache", {})
    made = []

    def build(common, size):
        digest = bytes(np.asarray(common.circuit_digest).tobytes())
        path = tagg._chunk_cache_path(digest, size)
        made.append("disk" if path.exists() else "build")
        path.write_bytes(b"x" * (10 + common.level))
        circuit = tagg._ChunkCircuit(data=_StubData(common.level + 1),
                                     verifier_data_target=None, proof_targets=[None] * size)
        if common.level == 0:
            tagg._chunk_circuit_cache[(digest, size)] = circuit
        return circuit

    monkeypatch.setattr(tagg, "build_chunk_circuit", build)
    tree = tagg.TreeAggregationConfig.new(2, 2)
    levels, first = bench.chunk_levels(_StubCommon(0), tree)
    assert [m[0] for m in first] == ["build", "build"] and [m[2] for m in first] == [10, 11]
    _, second = bench.chunk_levels(_StubCommon(0), tree)
    assert [m[0] for m in second] == ["memo", "disk"]
    assert made == ["build", "build", "disk", "disk"]
    assert len(levels) == 2 and all(m[1] >= 0 for m in first + second)


def test_bench_uses_a_temporary_cache_unless_one_is_named(monkeypatch, tmp_path, capsys):
    from qzk_tpu_torch.benches import aggregate as bench

    seen = []

    def run(grid, device):
        seen.append(os.environ["QZK_CIRCUIT_CACHE_DIR"])
        assert os.path.isdir(seen[-1]) and grid == [(2, 1)] and device.type == "cpu"
        yield {"metric": "stub"}

    monkeypatch.setattr(bench, "run", run)
    monkeypatch.delenv("QZK_CIRCUIT_CACHE_DIR")
    bench.main(["2,1", "--device", "cpu"])
    assert not os.path.exists(seen[0]) and "QZK_CIRCUIT_CACHE_DIR" not in os.environ
    monkeypatch.setenv("QZK_CIRCUIT_CACHE_DIR", str(tmp_path))
    bench.main(["2,1", "--device", "cpu"])
    assert seen[1] == str(tmp_path) and os.environ["QZK_CIRCUIT_CACHE_DIR"] == str(tmp_path)
    assert capsys.readouterr().out.count('"metric": "stub"') == 2


def test_build_chunk_cache_tool_walks_each_chain(monkeypatch, tmp_path, capsys):
    """tools/build_chunk_cache.py: one chunk circuit a level of each
    b:maxdepth chain, each level's child the level below, reported as a
    build or a cache hit; the memo is cleared after each level."""
    import json

    from qzk_tpu_torch.models.wormhole import circuit as tcircuit
    from qzk_tpu_torch.tools import build_chunk_cache as tool

    class _Leaf:
        def __init__(self, config):
            assert config.zero_knowledge

        def build_verifier(self):
            return _StubData(0)

    calls = []

    def build(common, size):
        calls.append((common.level, size))
        digest = bytes(np.asarray(common.circuit_digest).tobytes())
        tagg._chunk_cache_path(digest, size).write_bytes(b"blob")
        tagg._chunk_circuit_cache[(digest, size)] = "memo"
        return tagg._ChunkCircuit(data=_StubData(common.level + 1),
                                  verifier_data_target=None, proof_targets=[None] * size)

    monkeypatch.setenv("QZK_CIRCUIT_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(tcircuit, "WormholeCircuit", _Leaf)
    monkeypatch.setattr(tagg, "build_chunk_circuit", build)
    monkeypatch.setattr(tagg, "_chunk_circuit_cache", {})
    tool.main(["2:2", "3:1"])
    tool.main(["2:1"])
    assert calls == [(0, 2), (1, 2), (0, 3), (0, 2)]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    chunk_lines = [x for x in lines if x["metric"].startswith("chunk_circuit")]
    assert [(x["metric"], x["branching"], x["level"]) for x in chunk_lines] == [
        ("chunk_circuit_build", 2, 1), ("chunk_circuit_build", 2, 2),
        ("chunk_circuit_build", 3, 1), ("chunk_circuit_cache_hit", 2, 1)]
    assert tagg._chunk_circuit_cache == {}
    assert tool.parse_chain("7:2") == (7, 2)
    with pytest.raises(ValueError):
        tool.parse_chain("2:0")


def test_bench_rejects_a_root_without_the_leaf(monkeypatch):
    from qzk_tpu_torch.benches import aggregate as bench

    _stub_aggregation(monkeypatch)
    leaf = _StubProof(np.arange(16, dtype=np.uint64) + 1)
    dummy = _StubProof(np.zeros(16, dtype=np.uint64))
    monkeypatch.setattr(tagg.WormholeProofAggregator, "_load_dummy_proof", lambda self: dummy)
    real_pad = tagg.pad_with_dummy_proofs
    monkeypatch.setattr(tagg, "pad_with_dummy_proofs",
                        lambda proofs, n, d: real_pad([dummy], n, d))
    with pytest.raises(RuntimeError, match="leaf's public inputs"):
        bench.aggregate_point(_StubData(0), leaf, 2, 1, torch.device("cpu"), {})


def test_bench_grid_arguments(monkeypatch):
    from qzk_tpu_torch.benches import aggregate as bench

    assert bench._parse_point("2,3") == (2, 3)
    assert bench.DEFAULT_GRID == [(2, 1), (2, 2), (2, 3)]
    with pytest.raises(SystemExit):
        bench.main(["2,0", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["2,1"])
