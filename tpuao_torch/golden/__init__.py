"""Executable float64 PyTorch spec of the AO pipeline: the counterpart of
``tpuao.golden`` that runs on the card (``reference``: the frame;
``temporal``: the temporal resolve and the sequence oracles)."""
from tpuao_torch.golden.reference import (  # noqa: F401
    linearize_depth,
    downsample2x,
    build_pyramid,
    pad_parity4,
    render_ao_level,
    noise_filter,
    bilateral_upsample2x,
    blur_upsample_step,
    render_frame_golden,
    composite,
)
