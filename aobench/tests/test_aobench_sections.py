"""The cell ``high_16k.sections8``: its files, its traffic (one frame a
call through ``engine.render_sections``) and the sections layer's
readers, on the CPU at a small frame and on synthetic records; the last
test runs the cell at its own size and skips without a card.  Run it
there with

    python -m pytest -q aobench/tests/test_aobench_sections.py -m gpu
"""

import pathlib
import time

import pytest
import torch

from aobench import frameloop, harness

AOB = pathlib.Path(__file__).resolve().parents[1]
CELL = "high_16k.sections8"
NEW = ["halo_rows_pct.sections", "section_host_ms.sections",
       "section_keep_device_ms.sections"]
SHARED = ["host_ms_per_call.frame", "launches_per_frame.frame",
          "roofline_pct.frame", "idle_share.frame", "entry_self_ms.frame",
          "issue_idle_ms.frame"]
COUNTS = ("calls", "frames", "sections", "rows_rendered", "rows_kept")


def _read(name, rec):
    return harness.load_module(AOB / "metrics" / f"{name}.py").read(rec)


def test_the_cell_is_the_1080p_frame_program_at_16k():
    cell, wl, cfg = harness.load_cell(CELL)
    assert cell["chips"] == 1 and cell["config"] == cfg["name"] == "high_16k"
    assert cfg["frame"] == {"height": 8640, "width": 15360}
    assert cfg.get("cards", 1) == 1
    _, _, hd = harness.load_cell("high_1080p.stream")
    for key in ("camera", "ao", "impl", "out_dtype", "precision"):
        assert cfg[key] == hd[key], key
    assert wl["kind"] == "sections" and wl["sections"] == 8
    assert (wl["pool"], wl["n_spheres"], wl["dolly_step"]) == (4, 8, 0.05)
    assert (wl["warmup_calls"], wl["samples"], wl["trace_calls"]) == (8, 2,
                                                                      50)
    assert wl["check"] == {"max_abs_err": 1e-3}


def test_the_cells_metrics():
    bench = harness.spec()
    e2e = {m["name"] for m in harness.metrics_for(bench, CELL, False)}
    assert e2e == {"frame_ms", "peak_mem_mb", "setup_s"}
    layer = {m["name"] for m in harness.metrics_for(bench, CELL, True)}
    assert layer == set(SHARED) | set(NEW)
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL] and m["moves"] == "frame_ms"
            assert m["layer"] == "sections"


@pytest.mark.parametrize("rendered,kept,want", [
    (13_120, 8_640, 100 * (13_120 / 8_640 - 1)),  # 16K on 8: 51.85
    (5 * 13_120, 5 * 8_640, 100 * (13_120 / 8_640 - 1)),
    (8_640, 8_640, 0.0),  # one section renders the frame once
])
def test_halo_rows_share(monkeypatch, rendered, kept, want):
    from tpuao_torch.parallel import sections

    monkeypatch.setattr(sections, "section_counts", lambda: {
        "calls": 1, "frames": 1, "sections": 8, "rows_rendered": rendered,
        "rows_kept": kept})
    got = _read("halo_rows_pct.sections", {"device": {"platform": "gpu"}})
    assert got == pytest.approx(want)
    assert round(100 * (13_120 / 8_640 - 1), 2) == 51.85


def test_halo_rows_share_has_nothing_to_read(monkeypatch):
    """Off the card, on a program without the counter (the parent), and
    before any section was rendered, nothing is read."""
    from tpuao_torch.parallel import sections

    gpu = {"device": {"platform": "gpu"}}
    assert _read("halo_rows_pct.sections", {"device": {"platform": "cpu"}}
                 ) is None
    assert _read("halo_rows_pct.sections", {}) is None
    monkeypatch.setattr(sections, "section_counts",
                        lambda: dict.fromkeys(COUNTS, 0))
    assert _read("halo_rows_pct.sections", gpu) is None
    monkeypatch.delattr(sections, "section_counts")
    assert _read("halo_rows_pct.sections", gpu) is None


def _program_trace(host_spans, spans=None, device_ms=None):
    return {"program_trace": {"host": {"spans": host_spans},
                              "spans": spans or host_spans,
                              "device_ms": device_ms or {}}}


def test_sections_layer_by_host_and_device():
    """Host: the self time of ``ao_section`` plus the whole of
    ``ao_section_keep``; device: what ``ao_section_keep`` issued."""
    table = {"ao_entry.render_sections": [1, 0.9, 0.01],
             "ao_section": [8, 0.8, 0.05],
             "ao_section_keep": [8, 0.03, 0.03],
             "ao_prepare": [8, 0.2, 0.1],
             "ao_fused_l1": [8, 0.3, 0.1]}
    rec = _program_trace(table, device_ms={"ao_section_keep": 0.35,
                                           "ao_fused_l1": 3.1,
                                           "outside": 0.001})
    assert _read("section_host_ms.sections", rec) == pytest.approx(0.08)
    assert _read("section_keep_device_ms.sections", rec) == \
        pytest.approx(0.35)
    # the span, but no device operation issued under it
    rec["program_trace"]["device_ms"] = {"ao_fused_l1": 3.1}
    assert _read("section_keep_device_ms.sections", rec) == 0.0


@pytest.mark.parametrize("name", ["section_host_ms.sections",
                                  "section_keep_device_ms.sections"])
def test_sections_layer_nothing_to_read(name):
    """A program without the sections layer's spans (the parent: its
    frames open no entry span, so its program trace is None; or a trace
    of other entries), and a run without a program trace, read
    nothing."""
    other = {"ao_entry.render_frame": [100, 0.9, 0.5],
             "ao_graph_replay": [100, 0.4, 0.4]}
    assert _read(name, _program_trace(other)) is None
    assert _read(name, {"program_trace": None}) is None
    assert _read(name, {}) is None


def _ctx(trace, seconds=0.3, shape=(1080, 64), **workload):
    _, wl, cfg = harness.load_cell(CELL)
    return harness.Context(cell=CELL, workload={**wl, **workload},
                           config=cfg, seed=2**31 + 29, seconds=seconds,
                           trace=trace, device="cpu",
                           t0=time.perf_counter(), shape=shape)


def test_the_loop_records_what_the_frame_loop_records():
    """The sections loop's record has the frame loop's keys, traced and
    not; off the card the program trace is None; each sample is the
    sections call's output, which equals ``engine.render``'s."""
    from aobench import device as D

    sections = harness.load_module(AOB / "traffic" / "sections.py")
    quick = dict(warmup_calls=2, samples=2, trace_calls=2)
    for trace in (False, True):
        rec = sections.run(_ctx(trace, **quick))
        _, wl, cfg = harness.load_cell("high_1080p.stream")
        ctx = harness.Context(cell="high_1080p.stream",
                              workload={**wl, **quick}, config=cfg,
                              seed=2**31 + 29, seconds=0.3, trace=trace,
                              device="cpu", t0=time.perf_counter(),
                              shape=(1080, 64))
        want = frameloop.run(ctx, views=0)
        assert set(rec) == set(want)
        assert rec["frames"] == rec["calls"] == rec["attempted"]
        assert rec["failed"] == 0 and rec["samples"]
        if trace:
            assert rec["program_trace"] is None
            assert rec["profile"]["frames"] == 2
    eng = D.engine_of(harness.load_cell(CELL)[2], "cpu")
    for idx, out in rec["samples"]:
        assert torch.equal(out, eng.render(rec["pool"][0][idx]))


def test_the_cell_runs_correct_on_the_cpu():
    res, lines = harness.run_cell(CELL, 2**31 + 41, 0.3, False,
                                  device="cpu", shape=(4096, 64))
    assert res["correct"] is True and res["failed"] == 0
    assert {"frame_ms", "peak_mem_mb", "setup_s"} == set(res["metrics"])
    assert any(line.startswith("frame_ms by thirds") for line in lines)


def test_a_wrong_sections_call_is_not_correct(monkeypatch):
    """A section rendered from the wrong rows comes out not correct: the
    check holds the sections to the whole frame's reference."""
    from tpuao_torch.models.pipeline import AmbientOcclusionEngine as E

    full = E.render_sections

    def shifted(self, depth, n_sections=2, **kw):
        return full(self, depth.roll(64, dims=-2), n_sections, **kw)

    monkeypatch.setattr(E, "render_sections", shifted)
    res, _ = harness.run_cell(CELL, 2**31 + 41, 0.3, False, device="cpu",
                              shape=(4096, 64))
    assert res["correct"] is False


@pytest.mark.gpu
def test_the_cell_on_the_card():
    """The cell at 8640 x 15360, traced for a few seconds: correct, its
    end-to-end metrics, the halos' 51.85 % and both span readers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res, lines = harness.run_cell(CELL, 2**31 + 43, 3.0, True,
                                  device="cuda")
    print(res["metrics"], res["device"], lines)
    assert res["correct"] is True, res["check"]
    got = res["metrics"]
    assert got["halo_rows_pct.sections"]["value"] == pytest.approx(
        100 * (13_120 / 8_640 - 1))
    for name in NEW + ["entry_self_ms.frame", "issue_idle_ms.frame"]:
        assert name in got, name
