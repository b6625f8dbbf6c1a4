"""The ``graph_bound_pct`` readers on synthetic counts: the share of the
program's graph replays that ran on the call's own buffers, from
``frame_graph.graph_counts()``, and nothing to read off the card, without
the counters or without replays."""

import importlib.util
import pathlib

import pytest

from aobench import harness

AOB = pathlib.Path(__file__).resolve().parents[1]


def _read(name, rec):
    return harness.load_module(AOB / "metrics" / f"{name}.py").read(rec)


def _counts(replays, bound, **rest):
    return {"captures": 1, "replays": replays, "bound": bound,
            "inputs_bound": bound, "inputs_copied": replays - bound,
            "output_bound": bound, "output_cloned": replays - bound,
            "eager": {}, **rest}


@pytest.mark.parametrize("replays,bound,want", [
    (200, 200, 100.0),  # every replay on the call's own buffers
    (8, 6, 75.0),
    (5, 0, 0.0),  # graphs that copied and cloned on every replay
])
def test_bound_share_of_the_replays(monkeypatch, replays, bound, want):
    from tpuao_torch.models import frame_graph

    monkeypatch.setattr(frame_graph, "graph_counts",
                        lambda: _counts(replays, bound))
    card = {"device": {"platform": "gpu"}}
    assert _read("graph_bound_pct.frame", card) == pytest.approx(want)
    assert _read("graph_bound_pct.frame_p95", card) == pytest.approx(want)


def test_bound_share_has_nothing_to_read(monkeypatch):
    from tpuao_torch.models import frame_graph

    card = {"device": {"platform": "gpu"}}
    monkeypatch.setattr(frame_graph, "graph_counts",
                        lambda: _counts(10, 10))
    for rec in ({"device": {"platform": "cpu"}}, {}):  # off the card
        assert _read("graph_bound_pct.frame", rec) is None
    # a program whose counts lack the sides (graphs that always copied)
    monkeypatch.setattr(frame_graph, "graph_counts", lambda: {
        "captures": 1, "replays": 10, "eager": {}})
    assert _read("graph_bound_pct.frame", card) is None
    monkeypatch.setattr(frame_graph, "graph_counts", lambda: _counts(0, 0))
    assert _read("graph_bound_pct.frame", card) is None  # nothing replayed
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None if
                        name == "tpuao_torch.models.frame_graph"
                        else real(name))
    assert _read("graph_bound_pct.frame", card) is None  # no graphs
    assert _read("graph_bound_pct.frame_p95", card) is None


def test_bound_share_listed_in_the_benchmark():
    per_layer = {m["name"]: m for m in harness.spec()["per_layer"]}
    for name, moves, cells in (
            ("graph_bound_pct.frame", "frame_ms",
             ["ultra_4k.stream", "high_1080p.rig8", "high_1080p_x4.rig8"]),
            ("graph_bound_pct.frame_p95", "frame_ms_p95",
             ["high_1080p.stream"])):
        m = per_layer[name]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
                m["workloads"]) == ("%", "higher", "program_counter",
                                    "launch wrappers", moves, cells)
