"""The harness's arithmetic, its files, and the result line, on the CPU
(the port runs its plain versions there, at a small frame)."""

import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

import pytest

from aobench import harness, stats

ROOT = pathlib.Path(__file__).resolve().parents[2]
AOB = ROOT / "aobench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _metric(name):
    return harness.load_module(AOB / "metrics" / f"{name}.py").read


# -- arithmetic ---------------------------------------------------------------

def test_window_rate_counts_every_frame_of_a_call():
    rec = {"window_s": 2.0, "frames": 8 * 500, "call_latencies_s": [0.001]}
    assert _metric("frame_ms")(rec) == pytest.approx(2000.0 / 4000)
    assert _metric("frame_ms")({"window_s": 1.0}) is None


def test_p95_is_over_every_call():
    lat = [0.001] * 95 + [0.010] * 5
    assert _metric("frame_ms_p95")({"call_latencies_s": lat}) == \
        pytest.approx(1.0)
    lat = [0.001] * 94 + [0.010] * 6
    assert _metric("frame_ms_p95")({"call_latencies_s": lat}) == \
        pytest.approx(10.0)
    assert stats.percentile([3, 1, 2], 50) == 2
    assert stats.percentile([5], 95) == 5


def test_sample_times():
    times = stats.sample_times(10.0, 8, 99)
    assert len(times) == 8 and all(10 * j / 8 <= t < 10 * (j + 1) / 8
                                   for j, t in enumerate(times))
    assert times == stats.sample_times(10.0, 8, 99)


# -- files ----------------------------------------------------------------------

def test_benchmark_file_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {c["name"] for c in BENCH["workloads"]}
    assert "setup_s" in e2e
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        for n in names:
            assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert (AOB / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_every_cell_file_loads(cell):
    entry, wl, cfg = harness.load_cell(cell)
    assert wl["name"] == cell and wl["config"] == entry["config"]
    assert cfg["name"] == entry["config"]
    assert (AOB / "traffic" / f"{wl['kind']}.py").is_file()
    assert len(entry["why"]) <= 200
    # four chips only for a configuration of four cards whose traffic
    # sends views for the mesh to spread; every other cell takes one
    assert entry["chips"] == cfg.get("cards", 1)
    if entry["chips"] != 1:
        assert entry["chips"] == 4 and wl.get("views", 0) > 0
    assert 0 < wl["check"]["max_abs_err"] < 1e-2
    e2e = harness.metrics_for(BENCH, cell, False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert harness.metrics_for(BENCH, cell, True)


def test_four_chip_cells_are_few():
    """At most one cell on four chips, or a quarter of the cells rounded
    down where that is more."""
    chips = [c["chips"] for c in BENCH["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)


@pytest.mark.parametrize("path", sorted((AOB / "workloads").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_workload_file_loads(path):
    entry, wl, cfg = harness.load_cell(path.stem)
    assert wl["name"] == path.stem and entry["config"] == wl["config"]
    assert (AOB / "traffic" / f"{wl['kind']}.py").is_file()
    assert NAME.match(path.stem) and cfg["name"] == wl["config"]


@pytest.mark.parametrize("cfg", sorted((AOB / "configs").glob("*.json")))
def test_every_config_file_loads(cfg):
    from aobench.device import program_params
    from aobench.reference.params import from_config

    c = json.loads(cfg.read_text())
    assert c.get("cards", 1) in (1, 4)
    entry = {x["name"]: x for x in BENCH["configs"]}[c["name"]]
    assert entry["file"] == f"aobench/configs/{cfg.name}"
    params, camera = from_config(c)
    pcam, pparams = program_params(c)
    assert math.isclose(camera.tan_half_fov_h, pcam.tan_half_fov_h)
    assert params.use_normals == pparams.use_normals


# -- the result line ------------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    res, lines = harness.run_cell("high_1080p.stream", 2**31 + 5, 0.3, trace,
                                  device="cpu", shape=(64, 128))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(res) == keys + ["check"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = {m["name"] for m in harness.metrics_for(BENCH,
                                                   "high_1080p.stream",
                                                   trace)}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU runs no device operation: the trace's device metrics
        # find nothing to read and are left out
        want = {"host_ms_per_call.frame_p95", "mean_frame_ms.frame_p95"}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert lines[-4:] == [f"check {k} {v['value']!r} limit {v['limit']!r}"
                          for k, v in res["check"].items()]
    json.dumps(res, allow_nan=False)


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "aobench/run.py", "--workload", "high_1080p.stream",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    if "no CUDA device" not in out.stderr:
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("chips,cards", [(4, 1), (1, 4)])
def test_run_refuses_chips_unlike_the_cards(tmp_path, chips, cards):
    """A cell whose chips differ from its configuration's cards exits 2
    with no result, before any look for a card: a checkout of only the
    benchmark's files, with the rig cell or its configuration changed."""
    shutil.copytree(AOB, tmp_path / "aobench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["workloads"]:
        if c["name"] == "high_1080p.rig8":
            c["chips"] = chips
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = tmp_path / "aobench" / "configs" / "high_1080p.json"
    cfg.write_text(json.dumps({**json.loads(cfg.read_text()),
                               "cards": cards}))
    out = subprocess.run(
        [sys.executable, "aobench/run.py", "--workload", "high_1080p.rig8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 2 and out.stdout == ""
    assert f"asks for {chips} chips" in out.stderr
    assert f"for {cards} cards" in out.stderr
