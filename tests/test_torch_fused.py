"""The fused prove (plonk/device_prover.py: DeviceChallenger,
full_pipeline, _fused_prove) on the CPU, where full_pipeline's body runs
eagerly through the kernels' plain versions.

- The torch DeviceChallenger against the JAX package's DeviceChallenger
  (run eagerly) and the host Challenger, over seeded random schedules.
- The fused proof of test_torch_prover.py's small circuit, under both
  configs, byte for byte the JAX package's.
- A PoW batch that holds no hit takes the host grind, with the same
  bytes; a bad witness raises ValueError.
- full_pipeline's body makes no host transfer and no synchronisation:
  nothing that would break a CUDA graph capture on the card.
- The launch counting of a captured graph's replays.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp
import qzk_tpu.plonk.builder as jbuilder
import qzk_tpu.plonk.config as jconfig
import qzk_tpu.plonk.witness as jwitness
import qzk_tpu_torch.plonk.builder as tbuilder
import qzk_tpu_torch.plonk.config as tconfig
import qzk_tpu_torch.plonk.witness as twitness
from qzk_tpu.plonk.device_prover import DeviceChallenger as JaxDeviceChallenger
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.ops import ntt_cuda as nc
from qzk_tpu_torch.ops import poseidon_cuda as pc
from qzk_tpu_torch.ops.transcript import Challenger
from qzk_tpu_torch.plonk import device_prover as dp
from qzk_tpu_torch.plonk.prover import PhaseTimer, blinding_seed, blinding_stream


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- the device challenger ------------------------------------------------------


def _schedule(seed: int, steps: int = 40):
    """A seeded random transcript: (op, argument) pairs over canonical
    field elements."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        kind = rng.choice(["element", "elements", "cap", "challenge", "n_challenges", "ext"])
        if kind == "element":
            ops.append((kind, rng.integers(0, gl.P, dtype=np.uint64)))
        elif kind == "elements":
            n = int(rng.integers(0, 21))
            ops.append((kind, rng.integers(0, gl.P, size=n, dtype=np.uint64)))
        elif kind == "cap":
            ops.append((kind, rng.integers(0, gl.P, size=(1 << int(rng.integers(0, 5)), 4),
                                           dtype=np.uint64)))
        elif kind == "n_challenges":
            ops.append((kind, int(rng.integers(1, 12))))
        else:
            ops.append((kind, None))
    return ops


def _run_host(ch, ops):
    out = []
    for kind, arg in ops:
        if kind == "element":
            ch.observe_element(arg)
        elif kind == "elements":
            ch.observe_elements(arg)
        elif kind == "cap":
            ch.observe_cap(arg)
        elif kind == "challenge":
            out.append(np.array([ch.get_challenge()], dtype=np.uint64))
        elif kind == "n_challenges":
            out.append(np.asarray(ch.get_n_challenges(arg), dtype=np.uint64))
        else:
            out.append(np.asarray(ch.get_extension_challenge(), dtype=np.uint64))
    return out


def _run_device(ch, ops, to_dev, to_host):
    out = []
    for kind, arg in ops:
        if kind == "element":
            ch.observe_element(to_dev(np.asarray(arg, dtype=np.uint64)))
        elif kind in ("elements", "cap"):
            getattr(ch, "observe_cap" if kind == "cap" else "observe_elements")(to_dev(arg))
        elif kind == "challenge":
            out.append(to_host(ch.get_challenge()).reshape(1))
        elif kind == "n_challenges":
            out.append(to_host(ch.get_n_challenges(arg)))
        else:
            out.append(to_host(ch.get_extension_challenge()))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_device_challenger_matches_jax_and_host(seed):
    ops = _schedule(seed)
    host = Challenger()
    want = _run_host(host, ops)
    tdc = dp.DeviceChallenger("cpu")
    got = _run_device(tdc, ops, gt.from_u64, gt.to_u64)
    jdc = JaxDeviceChallenger()
    got_jax = _run_device(jdc, ops, jnp.asarray,
                          lambda a: np.asarray(a, dtype=np.uint64))
    assert len(got) == len(want) == len(got_jax)
    for g, j, w in zip(got, got_jax, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(j, w)
    state, inb, outb = (gt.to_u64(t) for t in tdc.export())
    jstate, jinb, joutb = (np.asarray(a, dtype=np.uint64) for a in jdc.export())
    # the host's native absorb stages pending input in state[:n_in]; the
    # next duplex overwrites those words, so compare the rest
    k = len(host.input_buf)
    np.testing.assert_array_equal(state[k:], host.state[k:])
    np.testing.assert_array_equal(inb, np.asarray(host.input_buf, dtype=np.uint64))
    np.testing.assert_array_equal(outb, np.asarray(host.output_buf, dtype=np.uint64))
    np.testing.assert_array_equal(jstate, state)
    np.testing.assert_array_equal(jinb, inb)
    np.testing.assert_array_equal(joutb, outb)


def test_device_challenger_fork_continues_the_transcript():
    """A fork (the query-index challenger of full_pipeline) continues
    the transcript as the host does, and leaves the original as it was."""
    ops = _schedule(7)
    host = Challenger()
    _run_host(host, ops)
    before = (host.state.copy(), np.asarray(host.input_buf, dtype=np.uint64),
              np.asarray(host.output_buf, dtype=np.uint64))
    tdc = dp.DeviceChallenger("cpu")
    _run_device(tdc, ops, gt.from_u64, gt.to_u64)
    fork = tdc.fork()
    fork.observe_element(gt.from_u64(np.uint64(12345)))
    host.observe_element(12345)
    np.testing.assert_array_equal(gt.to_u64(fork.get_n_challenges(11)),
                                  host.get_n_challenges(11))
    state, inb, outb = (gt.to_u64(t) for t in tdc.export())
    np.testing.assert_array_equal(state[len(inb):], before[0][len(inb):])
    np.testing.assert_array_equal(inb, before[1])
    np.testing.assert_array_equal(outb, before[2])


# -- the fused proof of the small circuit ------------------------------------------


def _build(builder_mod, config_mod, witness_mod, zk=False, x0=1000):
    """test_torch_prover.py's circuit, for either stack: every gate
    type; x0 is the first range-checked (32-bit) input."""
    cfg = config_mod.CircuitConfig.standard_recursion_config().with_zero_knowledge(zk)
    builder = builder_mod.CircuitBuilder(cfg)
    xs = [builder.add_virtual_target() for _ in range(4)]
    h = builder.hash_n_to_hash_no_pad(xs)
    builder.register_public_inputs(h.elements)
    for x in xs:
        builder.range_check(x, 32)
    y = builder.mul(xs[0], xs[1])
    z = builder.add(y, xs[2])
    builder.register_public_input(z)
    data = builder.build()
    pw = witness_mod.PartialWitness()
    for i, x in enumerate(xs):
        pw.set_target(x, (x0 if i == 0 else 1000) + i)
    return data, pw


@pytest.fixture(scope="module", params=[False, True], ids=["nonzk", "zk"])
def sides(request):
    """(JAX proof, port data, port witness, fused proof, fused timer) of
    the small circuit under one config."""
    zk = request.param
    jdata, jpw = _build(jbuilder, jconfig, jwitness, zk)
    tdata, tpw = _build(tbuilder, tconfig, twitness, zk)
    timer = PhaseTimer()
    fused = tdata.prove(tpw, device="cpu", timer=timer)
    return jdata.prove(jpw), tdata, tpw, fused, timer


def test_fused_proof_bytes_match_jax(sides):
    jproof, tdata, _, fused, _ = sides
    assert fused.to_bytes() == jproof.to_bytes()
    tdata.verify(fused)


def test_fused_timer_marks(sides):
    _, tdata, _, _, timer = sides
    names = [name for name, _ in timer.results()]
    assert names == (["witness"] + (["blinding"] if tdata.common.config.zero_knowledge else [])
                     + ["fused pipeline (device, 1 dispatch)", "PoW finalize (host)",
                        "FRI queries (in-dispatch gathers)"])


def test_pow_batch_miss_takes_the_host_grind(sides, monkeypatch):
    """A first PoW batch below the first hit (the fused proof's
    witness) holds no hit: the host grinds on from the batch's end,
    re-derives the indices, re-gathers, and gives the same bytes."""
    _, tdata, tpw, fused, _ = sides
    ctx = tdata.prover_only._torch_ctxs["cpu"]
    first_hit = fused.proof.fri.pow_witness
    assert first_hit > 0
    grinds = []
    real = ctx.grind_pow
    monkeypatch.setattr(ctx, "pow_batch", first_hit)
    monkeypatch.setattr(ctx, "grind_pow",
                        lambda ch, bits, start=0: grinds.append(start) or real(ch, bits, start))
    again = tdata.prove(tpw, device="cpu")
    assert grinds == [first_hit]
    assert again.to_bytes() == fused.to_bytes()


def test_bad_witness_raises_on_the_fused_path():
    """Witness values that satisfy no constraint (each one more than the
    generators' value) make the quotient's tail nonzero: ValueError."""
    data, pw = _build(tbuilder, tconfig, twitness)
    values, _ = twitness.run_generators(data.prover_only.plan, pw)
    bad = gl.add(values, np.uint64(1))
    dp.get_context(data.common, data.prover_only, "cpu").pow_batch = 1 << 6
    pi = np.zeros(4, dtype=np.uint64)
    with pytest.raises(ValueError, match="constraints unsatisfied"):
        dp.device_prove(data.common, data.prover_only, bad, None, pi[:0], pi,
                        lambda n: None, torch.device("cpu"))


# -- no transfer in the body ---------------------------------------------------------

_SYNCING = {"aten.lift_fresh.default", "aten._local_scalar_dense.default",
            "aten.nonzero.default", "aten.item.default", "aten.masked_select.default"}


class _NoHostTraffic(TorchDispatchMode):
    """Records every aten op that makes a tensor from host data, reads a
    value back to the host, or sizes its output by the data (boolean
    indexing): each breaks a CUDA graph capture."""

    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in _SYNCING:
            self.bad.append(str(func))
        if "index" in str(func):
            for a in args:
                for t in (a if isinstance(a, (list, tuple)) else [a]):
                    if isinstance(t, torch.Tensor) and t.dtype == torch.bool:
                        self.bad.append(f"{func} with a boolean index")
        return func(*args, **(kwargs or {}))


def _raiser(name):
    def f(*args, **kwargs):
        raise AssertionError(f"{name} called inside full_pipeline's body")
    return f


def test_full_pipeline_body_makes_no_transfer(sides, monkeypatch):
    """After a prove (its run is the warm-up a capture follows), the body
    runs with every host<->device helper patched to raise and under a
    dispatch mode that records host data and host reads."""
    _, data, pw, _, _ = sides
    zk = data.common.config.zero_knowledge
    ctx = dp.get_context(data.common, data.prover_only, "cpu")
    monkeypatch.setattr(ctx, "pow_batch", 1 << 6)
    values, _ = twitness.run_generators(data.prover_only.plan, pw)
    wire_matrix = ctx.assemble_wires(values)
    pi = gt.from_u64(np.arange(4, dtype=np.uint64))
    draw = blinding_stream(blinding_seed(values), "cpu")
    salts = tuple(draw((data.common.lde_size, 4)) if zk else None for _ in range(3))
    fn = ctx.full_pipeline(zk)
    want = fn(wire_matrix, pi, salts)[0]["packed"]
    for name in ("from_u64", "scalar", "to_u64"):
        monkeypatch.setattr(gt, name, _raiser(f"gt.{name}"))
    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, _raiser(f"torch.{name}"))
    for name in ("item", "cpu", "numpy", "tolist", "__bool__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, _raiser(f"Tensor.{name}"))
    mode = _NoHostTraffic()
    with mode:
        out, layout = fn(wire_matrix, pi, salts)
    monkeypatch.undo()
    assert mode.bad == []
    assert torch.equal(out["packed"], want)
    names = [n for n, _ in layout]
    assert {"tail_ok", "final_ok", "qidx", "pow_hit", "cap_wires", "rows_pre"} <= set(names)


# -- launch counting ------------------------------------------------------------------


@pytest.mark.parametrize("mod, key, shape", [
    (pc, "permute", None), (pc, "hash_rows", (64, 8)), (nc, "ntt_axis0", (1, 4, 8, False, True)),
])
def test_capture_records_and_replays_count(mod, key, shape):
    """Under recording() (a CUDA graph capture) a launch is recorded and
    not counted; each count_replay adds the recorded launches."""
    before = dict(mod.LAUNCHES)
    shapes = mod.K1_SHAPES if mod is pc else mod.K3_SHAPES
    shapes_before = shapes[shape] if shape is not None else 0
    with mod.recording() as rec:
        mod._count(key, shape)
        mod._count(key, shape)
    assert mod.LAUNCHES == before
    assert rec == {(key, shape): 2}
    mod.count_replay(rec)
    mod.count_replay(rec)
    assert mod.LAUNCHES[key] == before[key] + 4
    if shape is not None:
        assert shapes[shape] == shapes_before + 4
    mod._count(key, shape)  # outside a recording: counted
    assert mod.LAUNCHES[key] == before[key] + 5
