"""``library_kernel_ms.frame``: device ms per frame in kernels that are
not the port's own (every kernel name without ``tpuao::``: PyTorch's
elementwise, pad, copy and cat kernels), profiled sub-window."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("frames") or not prof["busy_s"] > 0:
        return None
    t = sum(s for name, (_, s) in prof["kernels"].items()
            if "tpuao::" not in name)
    return t * 1e3 / prof["frames"]
