"""The traced window's reduction: busy time as the union of each card's
device intervals inside the window, kernels by name, and idle gaps named
by the host phase that ran."""

import pytest

from harness import trace


def ev(name, ts, dur, cat="kernel", device=0):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "args": {"device": device}}


SYNC = {"ph": "X", "name": trace.SYNC, "ts": 1_000_000.0, "dur": 1, "cat": "user_annotation"}


def test_busy_idle_and_names():
    # host clock 10.0 s is trace 1_000_000 us; window [10.0, 10.01] s
    events = [SYNC,
              ev("void hash_rows_kernel<5>(unsigned long const*)", 1_000_000, 2000),
              ev("permute_kernel", 1_001_000, 2000),  # overlaps: union 3000 us
              ev("Memcpy HtoD", 1_005_000, 1000, cat="gpu_memcpy"),
              ev("cpu op", 1_006_000, 9000, cat="cpu_op"),  # host: not device time
              ev("late", 1_009_500, 5000)]  # clipped to the window: 500 us
    phases = [("witness", 10.003, 10.005), ("fused", 10.005, 10.0095)]
    s = trace.summarize(events, 10.0, 10.0, 10.01, phases)
    assert s.window_s == pytest.approx(0.01)
    assert s.busy_s[0] == pytest.approx(0.0045)
    assert s.idle_share(1) == pytest.approx(0.55)
    assert s.kernels["hash_rows_kernel"] == [pytest.approx(0.002), 1]
    assert s.kernel_events == 3
    assert s.idle_by_phase["witness"] == pytest.approx(0.002)
    assert s.idle_by_phase["fused"] == pytest.approx(0.0035)
    assert sum(s.idle_by_phase.values()) == pytest.approx(0.0055)


def test_cards_are_averaged():
    events = [SYNC, ev("k", 1_000_000, 10_000, device=0), ev("k", 1_000_000, 5_000, device=1)]
    s = trace.summarize(events, 10.0, 10.0, 10.01, [])
    assert s.mean_busy_s(2) == pytest.approx(0.0075)
    assert s.idle_share(4) == pytest.approx(1 - 0.015 / 4 / 0.01)


def test_a_trace_without_its_sync_is_refused():
    with pytest.raises(RuntimeError):
        trace.summarize([ev("k", 0, 1)], 0.0, 0.0, 1.0, [])


def test_kernel_names_group_instantiations():
    assert trace.kernel_name("void ntt_axis0_kernel<3>(Args)") == "ntt_axis0_kernel"
    assert trace.kernel_name("void at::native::(anonymous namespace)::f<int>(x)") == "at::native::f"
