"""The frozen work model against the port's ``utils.roofline`` at 1080p,
4K and a batch of 8."""

import pytest

from aobench import work
from aobench.reference.params import AO


@pytest.mark.parametrize("shape", [(1080, 1920), (2160, 3840)])
@pytest.mark.parametrize("use_normals", [False, True])
@pytest.mark.parametrize("batch", [1, 8])
def test_work_equals_port_roofline(shape, use_normals, batch):
    from tpuao_torch.params import AOParams
    from tpuao_torch.utils import roofline as R

    h, w = shape
    assert work.PEAK_FLOPS == R.PEAK_FLOPS and work.PEAK_BYTES == R.PEAK_BYTES
    kw = {"use_normals": use_normals}
    assert work.stage_traffic_bytes(h, w, **kw) == \
        R.stage_traffic_bytes(h, w, **kw)
    assert work.min_traffic_bytes(h, w, **kw) == \
        R.min_traffic_bytes(h, w, **kw)
    assert work.stage_work(h, w, AO(use_normals=use_normals), batch) == \
        R.stage_work(h, w, AOParams(use_normals=use_normals), batch)
    lv = (batch, h // 2, w // 2)
    assert work.render_work(lv, 34, 2) == R.render_work(lv, 34, 2)
    assert work.chain_work(lv, h, w, lo_inputs=3) == \
        R.chain_work(lv, h, w, lo_inputs=3)
    ops, nbytes = work.render_work(lv)
    assert work.bound(ops, nbytes) == R.bound(ops, nbytes)


def test_frame_bound_1080p():
    ms, by = work.frame_bound_ms(1080, 1920, AO())
    assert by == "bytes" and abs(ms - 0.0205619) < 1e-6
