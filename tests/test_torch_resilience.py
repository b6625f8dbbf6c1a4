"""tpuao_torch.utils.resilience, mirroring tests/test_resilience.py, with
the transient set written for CUDA: a sticky error (it poisons the CUDA
context) and out of memory are never retried."""

import numpy as np
import pytest
import torch

from tpuao_torch.models.pipeline import render_frame
from tpuao_torch.params import AOParams, CameraParams
from tpuao_torch.utils import resilience
from tpuao_torch.utils.resilience import is_transient, retry_transient

CAM = CameraParams(depth_mode="linear")


@pytest.mark.parametrize("msg", [
    "CUDA error: the launch timed out and was terminated",
    "CUDA error: unspecified launch timeout",
    "CUDA error: all CUDA-capable devices are busy or unavailable",
    "cudaErrorDevicesUnavailable"])
def test_transient_cuda_faults_retry_then_succeed(msg):
    calls = {"n": 0}

    @retry_transient(retries=3, backoff_s=0.0)
    def flaky(x):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError(msg)
        return x * 2

    assert is_transient(RuntimeError(msg))
    assert flaky(21) == 42 and calls["n"] == 3


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: misaligned address",
    "CUDA error: unspecified launch failure",
    "CUDA error: an illegal instruction was encountered",
    "CUDA out of memory. Tried to allocate 2.00 GiB",
    "cudaErrorMemoryAllocation",
    # a sticky error is never retried, whatever else the text says
    "CUDA error: the launch timed out; then an illegal memory access",
    "shape mismatch", "UNAVAILABLE: TPU worker process crashed"])
def test_sticky_oom_and_other_errors_reraise_at_once(msg):
    calls = {"n": 0}

    @retry_transient(retries=5, backoff_s=0.0)
    def broken(x):
        calls["n"] += 1
        raise RuntimeError(msg)

    assert not is_transient(RuntimeError(msg))
    with pytest.raises(RuntimeError):
        broken(1)
    assert calls["n"] == 1


def test_gives_up_after_retries(monkeypatch):
    slept = []
    monkeypatch.setattr(resilience.time, "sleep", slept.append)
    calls = {"n": 0}

    @retry_transient(retries=2, backoff_s=0.5)
    def always_down(x):
        calls["n"] += 1
        raise RuntimeError("CUDA error: the launch timed out")

    with pytest.raises(RuntimeError):
        always_down(1)
    assert calls["n"] == 3 and slept == [0.5, 1.0]


def test_wraps_a_real_render():
    fn = retry_transient(lambda d: render_frame(d, CAM, AOParams(),
                                                device="cpu"))
    out = fn(torch.full((64, 64), 0.4))
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-5)
    assert fn.__wrapped__ is not None
