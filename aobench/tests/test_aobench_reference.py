"""The frozen reference against the port's float64 spec
(``tpuao_torch.golden``) at small frames: HIGH and ULTRA, blur on,
hardware depth, through the benchmark's own scenes."""

import math

import pytest
import torch

from aobench.reference import golden
from aobench.reference.params import AO, Camera, build_pair_table
from aobench.scenes import dolly_pool

CAMERA = {"near": 0.1, "far": 100.0, "fov_h_deg": 60.0, "reversed_z": True,
          "depth_mode": "hardware"}


@pytest.mark.parametrize("shape", [(64, 128), (100, 150), (135, 240)])
@pytest.mark.parametrize("use_normals", [False, True])
def test_reference_equals_port_golden(shape, use_normals):
    from tpuao_torch.golden import render_frame_golden
    from tpuao_torch.params import AOParams, CameraParams

    depth, normals = dolly_pool(*shape, 2, 1234 + shape[0], CAMERA, "cpu",
                                with_normals=use_normals)
    ao = AO(use_normals=use_normals)
    cam = Camera(tan_half_fov_h=math.tan(math.radians(60.0) / 2))
    for f in range(2):
        n = None if normals is None else normals[f]
        ours = golden.render_frame(depth[f], cam, ao, n)
        theirs = render_frame_golden(
            depth[f], CameraParams(), AOParams(use_normals=use_normals),
            normals=n, device="cpu")
        assert ours.dtype == torch.float64
        assert float((ours - theirs).abs().max()) <= 1e-12
        assert float(ours.min()) < 0.99  # the scene occludes something


def test_pair_table_equals_port():
    from tpuao_torch.params import build_pair_table as port_table

    for exhaustive in (True, False):
        o1, w1 = build_pair_table(exhaustive)
        o2, w2 = port_table(exhaustive)
        assert (o1 == o2).all() and (w1 == w2).all()


def test_reference_in_lower_precision_keeps_its_dtype():
    depth, _ = dolly_pool(64, 128, 1, 5, CAMERA, "cpu")
    low = golden.render_frame(depth[0], Camera(), AO(), dtype=torch.bfloat16)
    assert low.dtype == torch.bfloat16 and low.shape == (64, 128)
