"""The control: the plain reference in bfloat16 put in the program's place
fails each cell's limit, where the program passes it.  On the CPU at a
small frame, by its gap and through a whole run of the harness; on the
card (marked ``gpu``) at the cells' own sizes."""

import pytest
import torch

from aobench import control, harness
from aobench.control import control_gap
from aobench.scenes import dolly_pool

CELLS = ["high_1080p.stream", "ultra_4k.stream", "high_1080p.rig8"]


def _gap(cell, seed, device, shape=None):
    _, wl, cfg = harness.load_cell(cell)
    h, w = shape or (cfg["frame"]["height"], cfg["frame"]["width"])
    depth, normals = dolly_pool(h, w, 2, seed, cfg["camera"], device,
                                n_spheres=wl["n_spheres"],
                                dolly_step=wl["dolly_step"],
                                with_normals=cfg["ao"]["use_normals"])
    return control_gap((depth, normals), cfg, range(2), device), wl


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit_on_the_cpu(cell):
    gap, wl = _gap(cell, 2**31 + 3, "cpu", (64, 128))
    assert gap > wl["check"]["max_abs_err"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_the_programs_place_is_not_correct(cell, monkeypatch):
    from tpuao_torch.models.pipeline import AmbientOcclusionEngine as E

    f = control.render(harness.load_cell(cell)[2])
    monkeypatch.setattr(E, "render",
                        lambda self, depth, normals=None, **kw:
                        f(depth, normals))
    monkeypatch.setattr(E, "render_views",
                        lambda self, depths, normals=None, **kw:
                        f(depths, normals))
    res, lines = harness.run_cell(cell, 2**31 + 5, 0.3, False,
                                  device="cpu", shape=(64, 128))
    assert res["correct"] is False
    err = res["check"]["max_abs_err"]
    assert err["value"] > err["limit"]
    assert any(line.startswith("check max_abs_err") for line in lines)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (11, 12, 13):
        gap, wl = _gap(cell, seed, "cuda")
        assert gap > wl["check"]["max_abs_err"]
