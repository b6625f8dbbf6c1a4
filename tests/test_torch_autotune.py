"""The port's tile-row autotuner (utils/autotune.py, utils/launch_opts.py)
and stage profile (utils/profiling.py), on the CPU.

Case for case the contracts of ``tests/test_autotune.py``: the sweep
itself is hardware-dependent (it times the kernels on the card), so these
tests inject a fake timer that reads the per-launch table, and check the
MACHINERY: candidate plumbing, restore after a sweep, argmin selection,
the exact-launch override ``tile_rows`` consults, JSON persistence with
the device-kind guard, and the CLI front end.  On the CPU every wrapper
runs its plain version, and ``record_launches`` still lists the launches
the card would make.
"""

import json

import numpy as np
import pytest
import torch

from tpuao_torch import cli as CLI
from tpuao_torch.ops import kernels as K
from tpuao_torch.params import AOParams, CameraParams
from tpuao_torch.utils import autotune
from tpuao_torch.utils import launch_opts as L
from tpuao_torch.utils.frameio import save_pfm

FUSED = "fused_render_upsample_step"


@pytest.fixture(autouse=True)
def _clean_table():
    L.clear_tuned_tiles()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    L.clear_tuned_tiles()
    torch.set_num_threads(n)


def fake_timer(times, key):
    """Timer stub: the time of the value the table holds for ``key`` (a
    launch) when it is called, recording each value it saw."""
    seen = []

    def timer(call):
        nt = L.tile_rows(*key)
        seen.append(nt)
        return times[nt]

    timer.seen = seen
    return timer


def frame_timer(times_by_kernel):
    """Timer stub for ``tune_frame``: it runs the call, watching which
    launches ask the table for their tile rows.  A call of one launch (a
    sweep) takes ``times_by_kernel[kernel][nt]`` at the value the table
    holds for it; a whole frame reads 0.5 when any of its launches is
    tuned, else 1.0."""
    def timer(call):
        asked, real = [], L.tile_rows
        L.tile_rows = lambda *key: asked.append(key) or real(*key)
        try:
            call()
        finally:
            L.tile_rows = real
        if len(asked) == 1:
            return times_by_kernel[asked[0][0]][real(*asked[0])]
        return 0.5 if any(real(*key) for key in asked) else 1.0

    return timer


def test_sweep_tiles_plumbs_candidates():
    key = (FUSED, 1, 544, 960)
    t = fake_timer({3: 3.0, 1: 1.0}, key)
    out = autotune.sweep_tiles(lambda x: x, torch.zeros(4), kernel=FUSED,
                               batch=1, h=544, w=960, candidates=(3, 1),
                               timer=t)
    assert out == {3: 3.0, 1: 1.0}
    assert t.seen == [3, 1]


def test_sweep_tiles_restores_the_prior_entry():
    """The entry that stood before the sweep comes back; with none, the
    sweep leaves the table clean (it must not leave its last candidate
    registered)."""
    key = (FUSED, 1, 544, 960)
    L.set_tuned_tiles(*key, 2)
    t = fake_timer({3: 2.0, 1: 1.0}, key)
    assert autotune.sweep_tiles(lambda: None, kernel=FUSED, batch=1, h=544,
                                w=960, candidates=(3, 1), timer=t) == \
        {3: 2.0, 1: 1.0}
    assert t.seen == [3, 1]
    assert L.tile_rows(*key) == 2  # restored
    other = (FUSED, 1, 545, 960)
    t = fake_timer({3: 1.0, 1: 1.0}, other)
    autotune.sweep_tiles(lambda: None, kernel=FUSED, batch=1, h=545, w=960,
                         candidates=(3, 1), timer=t)
    assert t.seen == [3, 1]
    assert L.tile_rows(*other) == 0  # the rule again


def test_sweep_tiles_refuses_a_value_with_no_instance():
    """A candidate the kernel has no instance for raises before it is
    timed, and the table is left as it was."""
    key = ("render_ao_level_normals", 1, 64, 96)
    t = fake_timer({1: 1.0}, key)
    with pytest.raises(ValueError, match="no instance"):
        autotune.sweep_tiles(lambda: None, kernel=key[0], batch=1, h=64,
                             w=96, candidates=(1, 2), timer=t)
    assert t.seen == [1]
    assert L.tile_rows(*key) == 0


def test_tune_frame_applies_exact_launch_override():
    """Each launch of the HIGH frame is swept alone and its winner
    registered for that exact launch; every other launch keeps the
    rule."""
    res = autotune.tune_frame(
        (64, 128), timer=frame_timer({
            "render_ao_level": {4: 0.9, 2: 0.5, 1: 0.7},
            "blur_upsample_step": {3: 0.2, 2: 0.3, 1: 0.4},
            FUSED: {3: 0.6, 2: 0.6, 1: 0.1}}), device="cpu")
    lv = [(64 >> l, 128 >> l) for l in range(5)]
    launches = {("render_ao_level", 1) + lv[4]: 2,
                ("blur_upsample_step", 1) + lv[4]: 3,
                (FUSED, 1) + lv[3]: 1, (FUSED, 1) + lv[2]: 1,
                (FUSED, 1) + lv[1]: 1}
    assert res["pixels"] == 64 * 128 and res["batch"] == 1
    assert res["use_normals"] is False
    assert res["best"] == {autotune.launch_label(k): nt
                           for k, nt in launches.items()}
    assert res["default"] == {autotune.launch_label(k): L.rule_nt(*k)
                              for k in launches}
    assert res["frame_ms"] == {"default": 1.0, "tuned": 0.5}
    assert res["sweep_ms"][autotune.launch_label((FUSED, 1) + lv[1])] == \
        {"3": 0.6, "2": 0.6, "1": 0.1}
    for k, nt in launches.items():
        assert L.tile_rows(*k) == nt
    assert L.tile_rows(FUSED, 2, *lv[1]) == 0  # another batch: the rule
    assert L.tile_rows(FUSED, 1, 33, 64) == 0  # another level
    assert len(L._TUNED) == len(launches)


def test_tune_frame_normals_keys_separately():
    res = autotune.tune_frame(
        (64, 128), use_normals=True, batch=2, device="cpu",
        timer=frame_timer({"render_ao_level_normals": {1: 0.3},
                           "blur_upsample_step": {3: 0.1, 2: 0.2, 1: 0.3}}))
    assert res["use_normals"] is True and res["batch"] == 2
    kernels = {k.split()[0] for k in res["best"]}
    assert kernels == {"render_ao_level_normals", "blur_upsample_step"}
    assert len(res["best"]) == 8  # four renders, four upsample steps
    assert L.tile_rows("render_ao_level_normals", 2, 32, 64) == 1
    assert L.tile_rows("blur_upsample_step", 2, 4, 8) == 3
    assert L.tile_rows("render_ao_level", 2, 4, 8) == 0
    assert L.tile_rows("blur_upsample_step", 1, 4, 8) == 0


def test_tune_frame_without_apply_leaves_the_table():
    L.set_tuned_tiles("blur_upsample_step", 1, 4, 8, 2)
    autotune.tune_frame((64, 128), apply=False, device="cpu",
                        timer=lambda call: 1.0)
    assert L._TUNED == {("blur_upsample_step", 1, 4, 8): 2}


def test_tune_frame_needs_a_timer_off_the_card():
    """On the CPU there is nothing to time: ``tune_frame`` raises rather
    than sweep the plain versions (the counterpart of tpuao's timer that
    drops the TPU flag off the TPU), and refuses a candidate no kernel
    has."""
    with pytest.raises(ValueError, match="timer"):
        autotune.tune_frame((64, 96), device="cpu")
    with pytest.raises(ValueError, match="candidates"):
        autotune.tune_frame((64, 96), device="cpu", candidates=(5,),
                            timer=lambda call: 1.0)
    assert L._TUNED == {}


def test_save_load_roundtrip(tmp_path):
    L.set_tuned_tiles("render_ao_level", 1, 68, 120, 2)
    L.set_tuned_tiles(FUSED, 4, 544, 960, 3)
    path = str(tmp_path / "tuned.json")
    autotune.save_tuned(path)
    L.clear_tuned_tiles()
    assert L.tile_rows("render_ao_level", 1, 68, 120) == 0
    assert autotune.load_tuned(path) == 2
    assert L.tile_rows("render_ao_level", 1, 68, 120) == 2
    assert L.tile_rows(FUSED, 4, 544, 960) == 3
    with open(path) as f:
        assert json.load(f)["device_kind"] == autotune.device_kind()


def test_load_rejects_foreign_device_kind(tmp_path):
    path = str(tmp_path / "tuned.json")
    with open(path, "w") as f:
        json.dump({"device_kind": "NVIDIA B9999",
                   "entries": [{"kernel": FUSED, "batch": 1, "h": 544,
                                "w": 960, "nt": 3}]}, f)
    assert autotune.load_tuned(path) == 0
    assert L.tile_rows(FUSED, 1, 544, 960) == 0
    assert autotune.load_tuned(path, strict_device=False) == 1
    assert L.tile_rows(FUSED, 1, 544, 960) == 3


def test_load_accepts_legacy_file_without_device_kind(tmp_path):
    """A hand-written cache with no device_kind key loads like 'unknown'
    (dropping its entries would let a later tune --save rewrite the file
    with only the fresh measurement)."""
    path = str(tmp_path / "legacy.json")
    with open(path, "w") as f:
        json.dump({"entries": [{"kernel": FUSED, "batch": 1, "h": 544,
                                "w": 960, "nt": 1}]}, f)
    assert autotune.load_tuned(path) == 1
    assert L.tile_rows(FUSED, 1, 544, 960) == 1


def _card_target(monkeypatch, timer):
    """Make the CLI's ``tune`` sweep on the CPU with ``timer``, as it
    sweeps on the card with ``cuda_graph_ms``."""
    monkeypatch.setattr(autotune, "sweep_target",
                        lambda: (torch.device("cpu"), timer))


def test_cli_tune_merges_legacy_cache(tmp_path, monkeypatch, capsys):
    """tune --save on a device_kind-less cache file merges, keeping the
    prior entries."""
    path = str(tmp_path / "legacy.json")
    with open(path, "w") as f:
        json.dump({"entries": [{"kernel": FUSED, "batch": 1, "h": 5,
                                "w": 7, "nt": 1}]}, f)
    _card_target(monkeypatch, frame_timer({
        "render_ao_level": {2: 0.1, 1: 0.2},
        "blur_upsample_step": {2: 0.2, 1: 0.1},
        FUSED: {2: 0.1, 1: 0.2}}))
    assert CLI.main(["tune", "64x128", "--candidates", "2,1",
                     "--save", path]) == 0
    capsys.readouterr()
    with open(path) as f:
        saved = json.load(f)
    ents = {(e["kernel"], e["batch"], e["h"], e["w"]): e["nt"]
            for e in saved["entries"]}
    assert ents == {(FUSED, 1, 5, 7): 1, ("render_ao_level", 1, 4, 8): 2,
                    ("blur_upsample_step", 1, 4, 8): 1, (FUSED, 1, 8, 16): 2,
                    (FUSED, 1, 16, 32): 2, (FUSED, 1, 32, 64): 2}


def test_cli_tune_without_a_card_exits_1(monkeypatch, capsys):
    """With no CUDA device ``tune`` exits 1 and sweeps nothing, where
    tpuao's warns and measures a program that drops the flag."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recorded = []
    monkeypatch.setattr(autotune, "tune_frame",
                        lambda *a, **k: recorded.append(a))
    assert CLI.main(["tune", "64x96"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert recorded == [] and L._TUNED == {}
    assert CLI.main(["tune", "64by96"]) == 2


def test_cli_tune_and_cache(tmp_path, monkeypatch, capsys):
    _card_target(monkeypatch, frame_timer({
        "render_ao_level": {4: 0.4, 2: 0.6, 1: 0.5},
        "blur_upsample_step": {3: 0.4, 2: 0.6, 1: 0.5},
        FUSED: {3: 0.6, 2: 0.4, 1: 0.5}}))
    path = str(tmp_path / "cache.json")
    assert CLI.main(["tune", "64x128", "--save", path]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["best"][autotune.launch_label(("render_ao_level", 1, 4,
                                              8))] == 4
    assert res["saved"] == path
    with open(path) as f:
        saved = json.load(f)
    assert len(saved["entries"]) == 5

    # a second tune for another shape MERGES into the same file
    assert CLI.main(["tune", "64x64", "--batch", "2", "--save", path]) == 0
    capsys.readouterr()
    with open(path) as f:
        saved = json.load(f)
    assert len(saved["entries"]) == 10

    # render --autotune-cache loads it (smoke: tiny frame through the CLI)
    L.clear_tuned_tiles()
    z = np.full((32, 64), 0.5, np.float32)
    save_pfm(str(tmp_path / "d.pfm"), z)
    assert CLI.main(["render", str(tmp_path / "d.pfm"),
                     str(tmp_path / "ao.pfm"), "--impl", "jnp",
                     "--depth-mode", "linear", "--device", "cpu",
                     "--autotune-cache", path]) == 0
    # every entry loaded from the cache before rendering
    assert L.tile_rows("render_ao_level", 1, 4, 8) == 4
    assert L.tile_rows(FUSED, 2, 32, 32) == 2
    assert len(L._TUNED) == 10
    capsys.readouterr()


def test_cli_tune_refuses_foreign_device_cache(tmp_path, monkeypatch,
                                               capsys):
    """tune --save must not overwrite a cache tuned on other hardware
    (save_tuned would rewrite it with only this process's entries)."""
    path = str(tmp_path / "c.json")
    prior = {"device_kind": "NVIDIA B9999",
             "entries": [{"kernel": FUSED, "batch": 1, "h": 5, "w": 7,
                          "nt": 1}]}
    with open(path, "w") as f:
        json.dump(prior, f)
    _card_target(monkeypatch, lambda call: 1.0)
    assert CLI.main(["tune", "64x96", "--save", path]) == 2
    capsys.readouterr()
    with open(path) as f:
        assert json.load(f) == prior  # untouched


# -- launch_opts ---------------------------------------------------------------

def test_tile_rows_defaults_and_validity():
    """0 (no entry) for every launch not in the table; only the instances
    each kernel has are taken."""
    for kernel, nts in L.VALID_NT.items():
        assert L.tile_rows(kernel, 1, 544, 960) == 0
        for nt in nts:
            L.set_tuned_tiles(kernel, 1, 544, 960, nt)
            assert L.tile_rows(kernel, 1, 544, 960) == nt
        for bad in {0, -1, 5, 3, 4, 2} - set(nts):
            with pytest.raises(ValueError, match="no instance"):
                L.set_tuned_tiles(kernel, 1, 544, 960, bad)
    assert L.VALID_NT == {"render_ao_level": (4, 2, 1),
                          "render_ao_level_normals": (1,),
                          "blur_upsample_step": (3, 2, 1), FUSED: (3, 2, 1)}
    for bad_kernel in ("windowed_resolve", "render_ao_level_dma",
                       "fused_render_upsample_step_zc"):
        with pytest.raises(ValueError, match="takes no tile rows"):
            L.set_tuned_tiles(bad_kernel, 1, 544, 960, 1)
    L.clear_tuned_tiles()
    assert L.tile_rows("render_ao_level", 1, 544, 960) == 0


@pytest.mark.parametrize("kernel,batch,lo,crop,want", [
    # 1080p HIGH, padded 1088 x 1920: the render at level 4, the steps
    # 3->2 and 1->0 (the last cropped to the frame), one and four frames
    ("render_ao_level", 1, (68, 120), None, 1),
    ("render_ao_level", 1, (544, 960), None, 4),
    ("render_ao_level", 1, (272, 480), None, 2),
    ("render_ao_level", 4, (272, 480), None, 4),
    ("render_ao_level_normals", 4, (2176, 3840), None, 1),
    (FUSED, 1, (136, 240), None, 1),
    (FUSED, 1, (544, 960), (1080, 1920), 2),
    (FUSED, 4, (544, 960), (1080, 1920), 3),
    ("blur_upsample_step", 1, (2176, 3840), (4320, 7680), 3),
    # the HIGH 1080p frame at the cells' other batches: two views a card
    # (the four-card rig) and the eight-view rig on one card
    ("render_ao_level", 2, (68, 120), None, 1),
    ("blur_upsample_step", 2, (68, 120), None, 1),
    (FUSED, 2, (136, 240), None, 1),
    (FUSED, 2, (272, 480), None, 2),
    (FUSED, 2, (544, 960), (1080, 1920), 3),
    ("render_ao_level", 8, (68, 120), None, 1),
    ("blur_upsample_step", 8, (68, 120), None, 1),
    (FUSED, 8, (136, 240), None, 2),
    (FUSED, 8, (272, 480), None, 3),
    (FUSED, 8, (544, 960), (1080, 1920), 3)])
def test_rule_nt(kernel, batch, lo, crop, want):
    """``rule_nt`` at the launches PERF.md and the card's sweep name:
    1080p step 1->0 at NT 2 with one frame (672 blocks), 3 with four
    (1664), the coarse levels at 1; at batches 2 and 8 the values the
    C launchers' own rule gave before the rule left them (the card's
    check against an older tree's library)."""
    assert L.rule_nt(kernel, batch, *lo, *(crop or ())) == want


@pytest.mark.parametrize("kernel", sorted(L.VALID_NT))
def test_tiles_resolve_every_launch_to_an_instance(kernel):
    """``kernels._tiles`` gives the launcher an instance, never 0: the
    table's value where it holds one (``tile_rows``), else ``rule_nt``.
    Outside a ``record_launches`` block it builds no call to repeat the
    launch (a wrapper of None would fail there)."""
    for batch, (h, w), crop in ((1, (68, 120), None),
                                (2, (544, 960), (1080, 1920)),
                                (8, (7, 9), (13, 17))):
        x = torch.zeros(batch, h, w)
        assert L.tile_rows(kernel, batch, h, w) == 0
        got = K._tiles(kernel, x, h, w, crop, None)
        assert got == L.rule_nt(kernel, batch, h, w, *(crop or ()))
        assert got in L.VALID_NT[kernel]
        for nt in L.VALID_NT[kernel]:
            L.set_tuned_tiles(kernel, batch, h, w, nt)
            assert K._tiles(kernel, x, h, w, crop, None) == nt == \
                L.tile_rows(kernel, batch, h, w)
        L.clear_tuned_tiles()


def test_record_launches_lists_the_frame_programs_launches():
    """The HIGH frame's five launches and the ULTRA frame's eight, on the
    CPU, in program order, without touching the launch counts; each
    call repeats its launch on the same inputs."""
    from tpuao_torch.models.pipeline import render_frame
    from tpuao_torch.models.presets import preset

    cam = CameraParams(depth_mode="linear")
    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.uniform(0.1, 1.0, (3, 100, 150)),
                        dtype=torch.float32)
    K.reset_launch_counts()
    with K.record_launches() as rec:
        want = render_frame(z, cam, device="cpu")
    assert [l.key for l in rec] == [
        ("render_ao_level", 3, 8, 12), ("blur_upsample_step", 3, 8, 12),
        (FUSED, 3, 16, 24), (FUSED, 3, 32, 48), (FUSED, 3, 64, 96)]
    assert [l.rule for l in rec] == [1, 1, 1, 1, 1]
    assert torch.equal(rec[-1].call(), want)
    assert set(K.launch_counts().values()) == {0}
    n = np.zeros((3, 100, 150, 3), np.float32)
    n[..., 2] = 1.0
    with K.record_launches() as rec:
        render_frame(z, cam, preset("ULTRA"), normals=torch.as_tensor(n),
                     device="cpu")
    assert [l.kernel for l in rec] == ["render_ao_level_normals"] * 4 + \
        ["blur_upsample_step"] * 4
    assert K._RECORD is None  # recording ends with the block


# -- profiling -----------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("blur", [True, False])
def test_stage_times_keys_equal_tpuao(depth, blur, monkeypatch):
    """``stage_times_ms`` reports tpuao's stage keys, in tpuao's order,
    for each hierarchy depth with blur on and off (fake timers on both
    sides: the stage programs run once on the CPU, untimed)."""
    import tpuao.params as JP
    from tpuao.utils import profiling as JPR

    from tpuao_torch.utils import profiling as PR

    monkeypatch.setattr(JPR, "device_time_ms", lambda *a, **k: 1.0)
    z = np.random.default_rng(1).uniform(0.1, 1.0, (64, 96)).astype(
        np.float32)
    jp = JP.AOParams(hierarchy_depth=depth, enable_blur=blur)
    want = JPR.stage_times_ms(z, JP.CameraParams(depth_mode="linear"), jp)
    calls = []
    got = PR.stage_times_ms(
        torch.as_tensor(z), CameraParams(depth_mode="linear"),
        AOParams(hierarchy_depth=depth, enable_blur=blur),
        timer=lambda call: calls.append(call()) or 1.0)
    assert list(got) == list(want)
    assert len(calls) == len(want) and set(got.values()) == {1.0}
    with pytest.raises(ValueError, match="timer"):
        PR.stage_times_ms(torch.as_tensor(z),
                          CameraParams(depth_mode="linear"), AOParams())
