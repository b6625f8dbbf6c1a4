"""``aobench/spans.py``'s join of the program's spans with a device trace,
on synthetic spans and device intervals, and its readers."""

import pathlib

import pytest

from aobench import harness, spans
from tpuao_torch.utils.trace import Record

AOB = pathlib.Path(__file__).resolve().parents[1]
ANCHOR = (1_000_000_000, 5_000)  # epoch ns = perf ns + 999_995_000
SHIFT = ANCHOR[0] - ANCHOR[1]


def _rec(name, s, e, parent=-1, frames=0):
    """A program span, given on the profiler's clock."""
    return Record(name, s - SHIFT, e - SHIFT, parent, frames)


# one call of two frames, on the profiler's clock (ns past the anchor):
#   entry 1000-9000 > prepare 1500-3000, render 3500-5000 > launch
#   4000-4500, fused 6000-8000 > launch 6500-7000
SPANS = [
    _rec("ao_entry.render_frame", ANCHOR[0] + 1000, ANCHOR[0] + 9000,
         frames=2),
    _rec("ao_prepare", ANCHOR[0] + 1500, ANCHOR[0] + 3000, 0),
    _rec("ao_render_l4", ANCHOR[0] + 3500, ANCHOR[0] + 5000, 0),
    _rec("ao_launch", ANCHOR[0] + 4000, ANCHOR[0] + 4500, 2),
    _rec("ao_fused_l3", ANCHOR[0] + 6000, ANCHOR[0] + 8000, 0),
    _rec("ao_launch", ANCHOR[0] + 6500, ANCHOR[0] + 7000, 4),
]


def _ev(kind, name, s, e, corr=0):
    return kind, name, ANCHOR[0] + s, ANCHOR[0] + e, corr


EVENTS = [
    _ev("host", "aobench.call", 500, 12000),
    _ev("host", "aobench.entry", 600, 9500),
    _ev("host", "aobench.sync", 9500, 12000),
    _ev("host", "aten::add", 1600, 1700, corr=11),  # a torch op's own id
    _ev("runtime", "cudaLaunchKernel", 1600, 1650, corr=11),
    _ev("device", "elementwise", 2000, 2400, corr=11),
    _ev("runtime", "cudaLaunchKernel", 4100, 4200, corr=12),
    _ev("device", "tpuao::render", 4300, 5300, corr=12),
    _ev("runtime", "cudaLaunchKernel", 6600, 6700, corr=13),
    _ev("device", "tpuao::fused", 6800, 10800, corr=13),
    _ev("device", "Memset", 11000, 11200, corr=99),  # no runtime event
]


def test_host_time_and_self_time_by_span():
    got = spans.join(SPANS, ANCHOR, EVENTS, dropped=0)
    assert got["frames"] == 2 and got["calls"] == 1 and got["dropped"] == 0
    t = got["spans"]
    # entry 8000 ns less its children 1500 + 1500 + 2000 = 3000 ns self,
    # per frame in ms
    assert t["ao_entry.render_frame"] == pytest.approx([1, 4e-3, 1.5e-3])
    assert t["ao_render_l4"] == pytest.approx([1, 0.75e-3, 0.5e-3])
    assert t["ao_fused_l3"] == pytest.approx([1, 1e-3, 0.75e-3])
    assert t["ao_launch"] == pytest.approx([2, 0.5e-3, 0.5e-3])
    assert got["launches"] == {"ao_render_l4": 0.5, "ao_fused_l3": 0.5}
    assert got["entry_host_ms"] == pytest.approx(8.9e-3 / 2)


def test_device_time_by_the_stage_that_issued_it():
    got = spans.join(SPANS, ANCHOR, EVENTS)
    # the runtime event's start, not the kernel's, picks the stage; the
    # launch span is lifted to its stage; a torch op sharing the id is not
    # a runtime event
    assert got["device_ms"] == pytest.approx({
        "ao_prepare": 0.4e-3 / 2, "ao_render_l4": 1e-3 / 2,
        "ao_fused_l3": 4e-3 / 2, "unjoined": 0.2e-3 / 2})
    assert got["busy_ms"] == pytest.approx(5.6e-3 / 2)
    assert got["window_ms"] == pytest.approx(11.5e-3 / 2)


def test_idle_gaps_by_the_innermost_span_or_outside():
    got = spans.join(SPANS, ANCHOR, EVENTS)
    # gaps: 500-2000 (mid 1250: entry), 2400-4300 (3350: entry, between
    # prepare and render), 5300-6800 (6050: fused), 10800-11000 and
    # 11200-12000 (the synchronise: outside)
    assert got["idle_ms"] == pytest.approx({
        "ao_entry.render_frame": (1.5e-3 + 1.9e-3) / 2,
        "ao_fused_l3": 1.5e-3 / 2, "outside": 1.0e-3 / 2})
    total = sum(got["idle_ms"].values())
    assert total == pytest.approx(got["window_ms"] - got["busy_ms"])
    read = harness.load_module(AOB / "metrics" / "issue_idle_ms.frame.py")
    assert read.read({"program_trace": got}) == pytest.approx(
        (1.5e-3 + 1.9e-3 + 1.5e-3) / 2)


def test_innermost_span_of_a_nested_entry():
    nested = [_rec("ao_entry.render_views", ANCHOR[0] + 0,
                   ANCHOR[0] + 10000, frames=8),
              _rec("ao_entry.render_frame", ANCHOR[0] + 100,
                   ANCHOR[0] + 9900, 0, frames=8),
              _rec("ao_prepare", ANCHOR[0] + 200, ANCHOR[0] + 9000, 1)]
    evs = [_ev("host", "aobench.call", 0, 10000),
           _ev("device", "k", 9500, 10000, corr=1),
           _ev("runtime", "cudaLaunchKernel", 300, 400, corr=1)]
    got = spans.join(nested, ANCHOR, evs)
    assert got["frames"] == 8  # top-level entries only
    assert got["device_ms"] == pytest.approx({"ao_prepare": 0.5e-3 / 8})
    assert got["idle_ms"] == pytest.approx({"ao_prepare": 9.5e-3 / 8})
    assert spans.join([], ANCHOR, evs) is None


def test_host_reading_of_the_pass_without_the_profiler():
    got = spans.host(SPANS, entry_ns=9000, calls=1, dropped=3)
    joined = spans.join(SPANS, ANCHOR, EVENTS)
    assert got["frames"] == 2 and got["calls"] == 1 and got["dropped"] == 3
    assert got["spans"] == joined["spans"]
    assert got["launches"] == joined["launches"]
    assert got["entry_host_ms"] == pytest.approx(9e-3 / 2)
    assert spans.host([], 9000, 1) is None


def test_readers_sum_their_spans():
    got = spans.join(SPANS, ANCHOR, EVENTS)
    # the host readers read the pass without the profiler: here the same
    # spans with prepare started 500 ns earlier, so that reading the
    # profiled pass's table would differ
    slow = [r._replace(start_ns=r.start_ns - 500 * (r.name == "ao_prepare"))
            for r in SPANS]
    got["host"] = spans.host(slow, 9000, 1)
    rec = {"program_trace": got}

    def read(name):
        return harness.load_module(AOB / "metrics" / f"{name}.py").read(rec)

    assert read("entry_self_ms.frame") == pytest.approx(1.25e-3)
    for name in ("entry_self_ms", "issue_idle_ms"):
        assert read(f"{name}.frame_p95") == read(f"{name}.frame")
        # a program without spans, or a run without a card: nothing read
        assert harness.load_module(
            AOB / "metrics" / f"{name}.frame.py").read(
                {"program_trace": None}) is None


def test_each_cell_keeps_the_trace_its_own_loop_made(monkeypatch):
    """Two cells of one configuration and one count of views a call (the
    1080p stream and a twin of it on another scene) each keep the program
    trace that their own loop made, on their own call after the window
    and its profiled calls; a record without one reads None."""
    import time

    import torch

    from aobench import device as D
    from aobench import frameloop

    made = []

    def fake(call, n, k0, mesh):
        made.append(call(k0))
        return {"n": n, "k0": k0, "mesh": mesh, "out": len(made) - 1}

    monkeypatch.setattr(spans, "trace_program", fake)
    _, wl, cfg = harness.load_cell("high_1080p.stream")
    quick = {**wl, "warmup_calls": 2, "samples": 1, "trace_calls": 3}
    twin = {**quick, "name": "high_1080p.twin", "n_spheres": 3,
            "dolly_step": 0.2, "trace_calls": 4}
    outs = []
    for w in (quick, twin):
        ctx = harness.Context(cell=w["name"], workload=w, config=cfg,
                              seed=2**31 + 3, seconds=0.2, trace=True,
                              device="cpu", t0=time.perf_counter(),
                              shape=(32, 64))
        rec = frameloop.run(ctx, views=0)
        pt = spans.program_trace(rec)
        assert pt["n"] == w["trace_calls"] and pt["mesh"] == ("cpu",)
        assert pt["k0"] == rec["calls"] + w["trace_calls"]
        depth = rec["pool"][0][pt["k0"] % w["pool"]]
        out = made[pt["out"]]
        assert torch.equal(out, D.engine_of(cfg, "cpu").render(depth))
        outs.append(out)
    assert not torch.equal(*outs)
    assert spans.program_trace({"calls": 10}) is None
