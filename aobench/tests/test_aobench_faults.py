"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a small frame, with one fault planted in the program
where its output is produced: an answer altered; a call that returns its
input unchanged (the frame renderer's counterpart of a step that returns
its state unchanged); half of a batch left out and the mean of the rest in
its place.  The cells run on one card, so there is no exchange between
cards to leave out.
"""

import pytest
import torch

from aobench import harness

SHAPE = (64, 128)


def _run(cell):
    res, _ = harness.run_cell(cell, 2**31 + 77, 0.3, False, device="cpu",
                              shape=SHAPE)
    return res


def _altered(fn):
    def wrapped(*a, **kw):
        out = fn(*a, **kw).clone()
        out.view(-1)[out.numel() // 3] += 0.01
        return out
    return wrapped


@pytest.fixture
def engine():
    from tpuao_torch.models.pipeline import AmbientOcclusionEngine

    return AmbientOcclusionEngine


@pytest.mark.parametrize("cell", ["high_1080p.stream", "ultra_4k.stream",
                                  "high_1080p.rig8"])
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("cell", ["high_1080p.stream", "ultra_4k.stream"])
def test_altered_answer(cell, engine, monkeypatch):
    monkeypatch.setattr(engine, "render", _altered(engine.render))
    res = _run(cell)
    assert res["correct"] is False
    assert res["check"]["max_abs_err"]["value"] >= 0.009


@pytest.mark.parametrize("cell", ["high_1080p.stream", "ultra_4k.stream"])
def test_input_returned_unchanged(cell, engine, monkeypatch):
    monkeypatch.setattr(engine, "render",
                        lambda self, depth, **kw: depth.clone())
    assert _run(cell)["correct"] is False


def test_rig_altered_answer(engine, monkeypatch):
    monkeypatch.setattr(engine, "render_views",
                        _altered(engine.render_views))
    assert _run("high_1080p.rig8")["correct"] is False


def test_rig_half_the_batch_left_out(engine, monkeypatch):
    full = engine.render_views

    def half(self, depths, **kw):
        n = depths.shape[0] // 2
        kept = full(self, depths[:n], **kw)
        rest = kept.mean(dim=0, keepdim=True).expand(
            depths.shape[0] - n, *kept.shape[1:])
        return torch.cat([kept, rest])

    monkeypatch.setattr(engine, "render_views", half)
    assert _run("high_1080p.rig8")["correct"] is False
