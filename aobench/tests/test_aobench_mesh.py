"""A configuration's ``cards``: the frame loop over a mesh, the device
readings over every card, and the trace's busy time by card.

On the CPU the mesh is the port's stand-in ``("cpu",) * 4`` at a small
frame; the last test runs the same four-card loop on four cards at 1080p
and skips without them.  Run it there with

    python -m pytest -q aobench/tests/test_aobench_mesh.py -m gpu
"""

import time
import types

import pytest
import torch

from aobench import device as D
from aobench import frameloop, harness, profiling

SHAPE = (64, 128)


def _ctx(cards: int, device: str = "cpu", shape=SHAPE, seconds=0.5,
         trace=False, **workload):
    """A run of the 8-view rig on ``high_1080p`` with ``cards`` cards,
    its workload's parameters overridden by ``workload``."""
    _, wl, cfg = harness.load_cell("high_1080p.rig8")
    return harness.Context(
        cell=f"high_1080p.rig8x{cards}", workload={**wl, **workload},
        config={**cfg, "cards": cards}, seed=2**31 + 19, seconds=seconds,
        trace=trace, device=device, t0=time.perf_counter(), shape=shape)


def test_mesh_of_a_configuration():
    assert D.mesh_of({"name": "c"}, "cpu") == ("cpu",)
    assert D.mesh_of({"name": "c", "cards": 4}, "cpu") == ("cpu",) * 4
    with pytest.raises(ValueError, match="cards must be 1 or 4"):
        D.mesh_of({"name": "c", "cards": 2}, "cpu")


def test_mesh_of_raises_where_the_cards_are_too_few(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="4 devices requested, have 2"):
        D.mesh_of({"name": "c", "cards": 4}, "cuda")
    assert D.mesh_of({"name": "c"}, "cuda") == (torch.device("cuda", 0),)


def test_readings_over_every_distinct_card(monkeypatch):
    """Each reading acts on each distinct card of the mesh, in its
    order; off the card there is none to read."""
    held = {0: 5, 1: 7, 3: 11}
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d: held[d.index])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: 10 * held[d.index])
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d: f"card {d.index}")
    reset = []
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset.append)
    mesh = ("cuda:1", "cuda:0", "cuda:1", "cuda:3")
    assert D.cards(mesh) == tuple(torch.device("cuda", i) for i in (1, 0, 3))
    assert D.allocated(mesh) == [7, 5, 11]
    assert D.peak(mesh) == [70, 50, 110]
    D.reset_peak(mesh)
    assert tuple(reset) == D.cards(mesh)
    assert D.entry(mesh, 110) == {"platform": "gpu", "kind": "card 1",
                                  "count": 3, "memory_peak_bytes": 110}
    cpu = ("cpu",) * 4
    assert D.cards(cpu) == () and D.allocated(cpu) == D.peak(cpu) == [0]
    assert D.entry(cpu, 0)["count"] == 1


def test_the_fullest_cards_window_peak(monkeypatch):
    """``peak_window_bytes`` is the fullest card's peak less what that
    card held at the window's start; ``memory_peak_bytes`` the fullest
    card's peak."""
    monkeypatch.setattr(D, "allocated", lambda mesh: [10, 100, 0, 0])
    monkeypatch.setattr(D, "peak", lambda mesh: [100, 120, 30, 30])
    rec = frameloop.run(_ctx(4, samples=1), views=8)
    assert rec["peak_window_bytes"] == 20
    assert rec["peak_bytes_by_card"] == [100, 120, 30, 30]
    assert rec["device"]["memory_peak_bytes"] == 120


def test_four_cards_render_what_one_renders():
    """The rig at 8 views a call over ``("cpu",) * 4`` (2 a card) gives
    the same samples as on one, bit for bit, and counts every view.  The
    pool holds one call's views, so both runs sample the same ones."""
    one = frameloop.run(_ctx(1, pool=8, samples=3), views=8)
    four = frameloop.run(_ctx(4, pool=8, samples=3, trace_calls=2,
                              warmup_calls=2), views=8)
    for rec in (one, four):
        assert rec["frames"] == rec["attempted"] == 8 * rec["calls"]
        assert rec["samples"]
    want = dict(one["samples"])
    assert sorted(want) == list(range(8))
    for idx, out in four["samples"]:
        assert torch.equal(out, want[idx]), idx


def test_a_traced_mesh_run_off_the_card():
    rec = frameloop.run(_ctx(4, trace=True, pool=8, samples=1,
                             trace_calls=2, warmup_calls=2), views=8)
    assert rec["program_trace"] is None
    assert rec["profile"]["busy_s_by_card"] == {}
    assert rec["profile"]["frames"] == 16


def test_a_mesh_needs_views():
    with pytest.raises(ValueError, match="spreads views"):
        frameloop.run(_ctx(4), views=0)


class _Event:
    """A torch.profiler record: on the host, or on card ``card``."""

    def __init__(self, name, start_ns, end_ns, card=None):
        self._args = name, start_ns, end_ns, card

    def name(self):
        return self._args[0]

    def start_ns(self):
        return self._args[1]

    def end_ns(self):
        return self._args[2]

    def device_index(self):
        return self._args[3]

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._args[3] is None
                else torch.autograd.DeviceType.CUDA)

    def is_user_annotation(self):
        return False


def test_busy_time_by_card():
    """Each card's busy time is the union of its own intervals in the
    window; ``busy_s`` stays the union over every card, so a gap counts
    as idle only where all cards are idle."""
    evs = [_Event("aobench.call", 1000, 2000),
           _Event("k", 1100, 1400, 0), _Event("k", 1300, 1500, 0),
           _Event("k", 1450, 1900, 1), _Event("k", 1950, 2500, 3),
           _Event("k", 500, 800, 2)]  # before the window
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    got = profiling.summarize(prof, "aobench.call")
    assert got["busy_s_by_card"] == pytest.approx(
        {0: 400e-9, 1: 450e-9, 3: 50e-9}, abs=1e-15)
    assert list(got["busy_s_by_card"]) == [0, 1, 3]
    assert got["busy_s"] == pytest.approx(850e-9, abs=1e-15)
    assert sum(got["idle"].values()) == pytest.approx(150e-9, abs=1e-15)


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: the mesh spreads a call's "
                    "views over cuda:0 .. cuda:3")


@pytest.mark.gpu
def test_the_four_card_loop_on_four_cards(four_cards):
    """The rig at 1080p, 8 views a call and 2 a card, traced for a few
    seconds on four cards: every sample within the workload's limit of the
    reference, four cards counted and each one's peak read, and the
    program trace's ``ao_entry.render_views`` at 8 frames a call."""
    ctx = _ctx(4, device="cuda", shape=None, seconds=3.0, trace=True)
    rec = frameloop.run(ctx, views=8)
    check = harness.judge(rec.pop("samples"), rec.pop("pool"), ctx.config,
                          ctx.workload["check"]["max_abs_err"], "cuda")
    print(check, rec["device"], rec["peak_bytes_by_card"],
          rec["profile"]["busy_s_by_card"])
    assert harness.correct_of(check), check
    assert rec["device"]["count"] == 4
    assert len(rec["peak_bytes_by_card"]) == 4
    assert all(b > 0 for b in rec["peak_bytes_by_card"])
    assert set(rec["profile"]["busy_s_by_card"]) == {0, 1, 2, 3}
    pt = rec["program_trace"]
    assert pt is not None and pt["calls"] == ctx.workload["trace_calls"]
    assert pt["frames"] == 8 * pt["calls"]
    assert pt["spans"]["ao_entry.render_views"][0] == pt["calls"]
    assert pt["host"]["frames"] == 8 * pt["host"]["calls"]
