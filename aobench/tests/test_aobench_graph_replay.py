"""The ``graph_replay_pct`` readers on synthetic span tables: the count of
``ao_graph_replay`` spans over the count of ``ao_entry.render_frame``
spans, from the program-traced phase's pass without the profiler; and
``graph_pool_mb``, the bytes the program's graphs hold in their pools."""

import importlib.util
import pathlib

import pytest

from aobench import harness, spans
from tpuao_torch.utils.trace import Record

AOB = pathlib.Path(__file__).resolve().parents[1]


def _calls(n_eager: int, n_replay: int, frames: int = 1, views=False):
    """Spans of ``n_eager`` eager calls (prepare and a stage) and
    ``n_replay`` replayed ones, each ``frames`` frames, one after another;
    under a ``render_views`` entry where ``views``."""
    out, t = [], 0
    for replayed in [False] * n_eager + [True] * n_replay:
        top = -1
        if views:
            top = len(out)
            out.append(Record("ao_entry.render_views", t, t + 100, -1,
                              frames))
        entry = len(out)
        out.append(Record("ao_entry.render_frame", t + 1, t + 99, top,
                          0 if views else frames))
        if replayed:
            out.append(Record("ao_graph_replay", t + 2, t + 50, entry, 0))
        else:
            out.append(Record("ao_prepare", t + 2, t + 20, entry, 0))
            out.append(Record("ao_fused_l1", t + 30, t + 60, entry, 0))
        t += 100
    return out


def _read(name, rec):
    return harness.load_module(AOB / "metrics" / f"{name}.py").read(rec)


@pytest.mark.parametrize("n_eager,n_replay,frames,views,want", [
    (0, 200, 1, False, 100.0),  # the 1080p stream after its warm-up
    (1, 3, 1, False, 75.0),
    (4, 0, 1, False, 0.0),  # a program with graphs that never replayed
    (0, 100, 8, True, 100.0),  # the rig: one render_frame a call of 8
    (1, 1, 8, True, 50.0),
])
def test_replay_share_of_the_frame_entries(n_eager, n_replay, frames, views,
                                           want):
    rec = {"program_trace": {"host": spans.host(
        _calls(n_eager, n_replay, frames, views), 1000,
        n_eager + n_replay)}}
    assert _read("graph_replay_pct.frame", rec) == pytest.approx(want)
    assert _read("graph_replay_pct.frame_p95", rec) == pytest.approx(want)


def test_nothing_to_read(monkeypatch):
    # no trace (no card), no host pass, no frame entry
    for pt in (None, {"host": None}, {"host": {"spans": {}}}):
        assert _read("graph_replay_pct.frame", {"program_trace": pt}) is None
    # a program without graphs has nothing to read, whatever its spans
    rec = {"program_trace": {"host": spans.host(_calls(2, 0), 1000, 2)}}
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None if
                        name == "tpuao_torch.models.frame_graph"
                        else real(name))
    assert _read("graph_replay_pct.frame", rec) is None
    assert _read("graph_replay_pct.frame_p95", rec) is None


def _reporting(bench, metric):
    """The cells that report the end-to-end ``metric``."""
    return {c["name"] for c in bench["workloads"]
            if metric in {m["name"] for m in
                          harness.metrics_for(bench, c["name"], False)}}


def test_listed_in_the_benchmark():
    bench = harness.spec()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name, moves, cells in (
            ("graph_replay_pct.frame", "frame_ms",
             ["ultra_4k.stream", "high_1080p.rig8"]),
            ("graph_replay_pct.frame_p95", "frame_ms_p95",
             ["high_1080p.stream"])):
        m = per_layer[name]
        assert (m["unit"], m["better"], m["layer"], m["moves"]) == (
            "%", "higher", "launch wrappers", moves)
        # the cells it came with, and any added since, each reporting
        # the end-to-end metric it moves
        assert set(cells) <= set(m["workloads"]) <= _reporting(bench, moves)


def test_pool_reading_is_the_cached_graphs_bytes(monkeypatch):
    from tpuao_torch.models import frame_graph

    card = {"device": {"platform": "gpu"}}
    monkeypatch.setattr(frame_graph, "pool_bytes", lambda: 341_835_776)
    assert _read("graph_pool_mb", card) == pytest.approx(341.835776)
    assert _read("graph_pool_mb", {"device": {"platform": "cpu"}}) is None
    monkeypatch.setattr(frame_graph, "pool_bytes", lambda: 0)
    assert _read("graph_pool_mb", card) == 0.0  # graphs, none cached
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None if
                        name == "tpuao_torch.models.frame_graph"
                        else real(name))
    assert _read("graph_pool_mb", card) is None  # a program without graphs


def test_pool_reading_sums_the_entries_the_cache_holds(monkeypatch):
    """``frame_graph.pool_bytes`` on entries stubbed in (the captures run
    on the card): what the cache holds now, evicted entries left out."""
    import types

    import torch

    from tpuao_torch.models import frame_graph

    frame_graph._clear()
    try:
        monkeypatch.setattr(frame_graph, "_bound", lambda device: 10 ** 9)
        monkeypatch.setattr(frame_graph, "MAX_ENTRIES", 2)
        for key, nbytes in (("a", 67_108_864), ("b", 1_000_000),
                            ("c", 2_000_000)):
            frame_graph._insert(key, types.SimpleNamespace(nbytes=nbytes),
                                torch.device("cpu"))
        assert frame_graph.pool_bytes() == 3_000_000  # "a" evicted
        assert _read("graph_pool_mb", {"device": {"platform": "gpu"}}) == \
            pytest.approx(3.0)
    finally:
        frame_graph._clear()


def test_pool_reading_listed_in_the_benchmark():
    bench = harness.spec()
    m = {m["name"]: m for m in bench["per_layer"]}["graph_pool_mb"]
    assert (m["unit"], m["better"], m["source"], m["layer"],
            m["moves"]) == ("MB", "lower", "program_counter",
                            "launch wrappers", "peak_mem_mb")
    assert {"high_1080p.stream", "ultra_4k.stream", "high_1080p.rig8"} <= \
        set(m["workloads"]) <= _reporting(bench, "peak_mem_mb")
