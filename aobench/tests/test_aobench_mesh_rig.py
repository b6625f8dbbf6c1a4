"""The four-card rig ``high_1080p_x4.rig8``: its files, the metrics it
reports, the readers of the sharding layer and of the cards one by one on
synthetic records, and the frozen count of the bytes a call copies
between cards.  The last test runs the cell for a few seconds on four
cards and skips without them:

    python -m pytest -q aobench/tests/test_aobench_mesh_rig.py -m gpu
"""

import pathlib

import pytest
import torch

from aobench import harness, mesh_work
from aobench.reference.params import from_config
from aobench.work import frame_bound_ms

AOB = pathlib.Path(__file__).resolve().parents[1]
CELL = "high_1080p_x4.rig8"
NEW = ("shard_host_ms.mesh", "shard_device_ms.mesh",
       "peer_mb_per_frame.mesh", "peer_link_pct.mesh",
       "card_idle_share.mesh", "roofline_pct.mesh")
SHARED = ("host_ms_per_call.frame", "launches_per_frame.frame",
          "library_kernel_ms.frame", "entry_self_ms.frame",
          "graph_replay_pct.frame", "graph_pool_mb")
UNIONS = ("idle_share.frame", "roofline_pct.frame", "issue_idle_ms.frame")
PER_CALL = 99_532_800  # 3 cards x 2 views x 1080 x 1920 x 4 B, in and out


def _read(name, rec):
    return harness.load_module(AOB / "metrics" / f"{name}.py").read(rec)


def test_the_cell_spans_four_cards():
    cell, wl, cfg = harness.load_cell(CELL)
    assert cell["chips"] == cfg["cards"] == 4
    assert cell["config"] == cfg["name"] == "high_1080p_x4"
    assert wl["kind"] == "rig" and wl["views"] == 8 and wl["pool"] == 16
    assert wl["samples"] == 2 and wl["check"] == {"max_abs_err": 1e-3}
    # the one-card rig's frame program, on four cards
    _, _, one = harness.load_cell("high_1080p.rig8")
    for key in ("frame", "camera", "ao", "impl", "out_dtype", "precision"):
        assert cfg[key] == one[key], key


def test_the_cells_metrics():
    bench = harness.spec()
    e2e = {m["name"] for m in harness.metrics_for(bench, CELL, False)}
    assert e2e == {"frame_ms", "peak_mem_mb", "setup_s"}
    layer = {m["name"] for m in harness.metrics_for(bench, CELL, True)}
    # the sharding layer's own; besides them only what the one-card rig
    # reports too, the shared ones among it, whatever later cells add
    one_card = {m["name"] for m in harness.metrics_for(bench,
                                                       "high_1080p.rig8",
                                                       True)}
    assert set(SHARED) | set(NEW) <= layer
    assert layer - set(NEW) <= one_card
    assert not layer & set(UNIONS)
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL] and m["moves"] == "frame_ms"


@pytest.mark.parametrize("h,w,views,cards,normals,want", [
    (1080, 1920, 8, 4, False, PER_CALL),
    (1080, 1920, 5, 4, False, 3 * 2 * 1080 * 1920 * 4 * 2),  # padded
    (1080, 1920, 8, 1, False, 0),
    (64, 128, 8, 4, True, 3 * 2 * 64 * 128 * 4 * 5),  # normals too
])
def test_peer_bytes_per_call(h, w, views, cards, normals, want):
    assert mesh_work.peer_bytes_per_call(h, w, views, cards, normals) == want


def _program_trace(host_spans, spans=None, device_ms=None):
    return {"program_trace": {"host": {"spans": host_spans},
                              "spans": spans or host_spans,
                              "device_ms": device_ms or {}}}


def test_sharding_spans_by_host_and_device():
    table = {"ao_entry.render_views": [100, 0.9, 0.01],
             "ao_scatter": [400, 0.02, 0.02],
             "ao_gather": [100, 0.03, 0.01],
             "ao_graph_replay": [400, 0.4, 0.4]}
    rec = _program_trace(table, device_ms={"ao_scatter": 0.011,
                                           "ao_gather": 0.019,
                                           "ao_graph_replay": 0.2,
                                           "outside": 0.001})
    assert _read("shard_host_ms.mesh", rec) == pytest.approx(0.05)
    assert _read("shard_device_ms.mesh", rec) == pytest.approx(0.03)
    # the spans but no device operation issued under them
    rec["program_trace"]["device_ms"] = {"ao_graph_replay": 0.2}
    assert _read("shard_device_ms.mesh", rec) == 0.0


@pytest.mark.parametrize("name", ["shard_host_ms.mesh",
                                  "shard_device_ms.mesh"])
def test_sharding_spans_nothing_to_read(name):
    """A program without the sharding layer's spans (the parent), and a
    run without a program trace (off the card), read nothing."""
    parent = {"ao_entry.render_views": [100, 0.9, 0.5],
              "ao_graph_replay": [400, 0.4, 0.4]}
    assert _read(name, _program_trace(parent)) is None
    assert _read(name, {"program_trace": None}) is None
    assert _read(name, {}) is None


def test_peer_mb_per_frame(monkeypatch):
    from tpuao_torch.parallel import sharding

    monkeypatch.setattr(sharding, "mesh_counts", lambda: {
        "calls": 10, "frames": 80, "shards": 40,
        "peer_bytes": 10 * PER_CALL})
    gpu = {"device": {"platform": "gpu"}}
    assert _read("peer_mb_per_frame.mesh", gpu) == pytest.approx(12.4416)
    assert _read("peer_mb_per_frame.mesh", {"device": {"platform": "cpu"}}
                 ) is None
    monkeypatch.delattr(sharding, "mesh_counts")  # a program without it
    assert _read("peer_mb_per_frame.mesh", gpu) is None


def _profiled(copies=None, busy_by_card=None, window_s=0.2):
    """A traced record of the cell: 10 window calls, 100 profiled calls
    of 8 views."""
    _, _, cfg = harness.load_cell(CELL)
    return {"config": cfg, "frame_shape": (1080, 1920), "frames": 80,
            "calls": 10, "device": {"platform": "gpu", "count": 4},
            "profile": {"frames": 800, "window_s": window_s,
                        "busy_s": 0.05, "copies": copies or {},
                        "busy_s_by_card": busy_by_card or {}}}


def test_peer_link_share():
    rec = _profiled(copies={"Memcpy PtoP ": [600, 0.25],
                            "Memcpy DtoD ": [100, 0.5],
                            "Memcpy HtoD ": [2, 0.5]})
    # 100 calls x 99,532,800 B at 450 GB/s over 0.25 s of peer copies
    assert _read("peer_link_pct.mesh", rec) == pytest.approx(8.84736)
    # copies between cards not named apart from the others: nothing
    rec["profile"]["copies"] = {"Memcpy DtoD ": [700, 0.75]}
    assert _read("peer_link_pct.mesh", rec) is None
    assert _read("peer_link_pct.mesh", {}) is None


def test_cards_one_by_one():
    """Each card's own busy time, a card with no operation idle: 0.08
    card-seconds busy of 4 x 0.2."""
    rec = _profiled(busy_by_card={0: 0.04, 1: 0.02, 3: 0.02})
    assert _read("card_idle_share.mesh", rec) == pytest.approx(90.0)
    params, _ = from_config(rec["config"])
    bound_ms, _ = frame_bound_ms(1080, 1920, params)
    assert _read("roofline_pct.mesh", rec) == pytest.approx(
        100.0 * bound_ms * 800 / 80.0)
    for name in ("card_idle_share.mesh", "roofline_pct.mesh"):
        assert _read(name, _profiled()) is None  # off the card
        assert _read(name, {}) is None


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: the cell spreads a call's "
                    "views over cuda:0 .. cuda:3")


@pytest.mark.gpu
def test_the_cell_on_four_cards(four_cards):
    """The cell for a few seconds, traced: correct, four cards, every
    call replayed, and each new metric a number in its range."""
    from tpuao_torch.parallel import sharding

    sharding._clear()
    result, lines = harness.run_cell(CELL, seed=2**31 + 20, seconds=3.0,
                                     trace=True, device="cuda")
    print(result["device"], result["metrics"], *lines, sep="\n")
    assert result["correct"], result["check"]
    assert result["check"]["samples"]["value"] == 16
    assert result["device"]["count"] == 4
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["graph_replay_pct.frame"] == 100.0
    assert m["peer_mb_per_frame.mesh"] == pytest.approx(PER_CALL / 8 / 1e6)
    assert m["shard_host_ms.mesh"] > 0 and m["shard_device_ms.mesh"] > 0
    for name in ("card_idle_share.mesh", "roofline_pct.mesh",
                 "peer_link_pct.mesh"):
        if name in m or name != "peer_link_pct.mesh":
            assert 0 < m[name] <= 100, (name, m[name])
