#!/usr/bin/env python3
"""A 1080p calibration step of ``models/autodiff.fit_tunables`` on a GPU,
with two forms of the plain render's gradient clamp side by side.

    python3 scripts/fit_step_ab.py

Under autograd ``ops/render._clip`` is ``min(max(x, lo), hi)``.  The form
in the tree passes the bounds as 0-d CPU tensors, which a binary op on the
card reads as scalars; the dropped form made them with ``x.new_tensor``,
a host-to-device copy each.  The script runs the calibration of
``examples/calibrate.py`` (spheres on a plane, hidden strength 1.8 and
rejection_falloff 4.0, both fitted from the defaults, lr 0.08) with each
form in turns (old, new, new, old): host ms a step over 10 steps (with a
synchronise), device ms a step and device records a step by
torch.profiler, the idle share, and whether losses and fitted values are
bit-equal to the first turn's.  Then a census of one step with each form:
its device records by name and the host's CUDA runtime calls by name, and
the same for 100 bare ``x.new_tensor(0.0)`` on the card.  Prints the
card's name and power limit beside every number; exits non-zero without a
CUDA device or when a turn's fit differs.
"""

from __future__ import annotations

import collections
import pathlib
import re
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def old_clip(x, lo, hi):
    """The dropped form: the bounds as device tensors."""
    import torch

    if not (x.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                         x.new_tensor(hi))


def census(fn, label, card):
    """One call of ``fn`` under torch.profiler: device records and host
    CUDA runtime calls, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_dev, on_host = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            on_dev[re.sub(r"^void |[(<].*$|^(?:at::native::|tpuao::)", "",
                          name)[:50]] += 1
        elif e.name.startswith("cuda"):
            on_host[e.name] += 1
    print(f"{label}: {sum(on_dev.values())} device records [{card}]")
    for name, n in on_dev.most_common(20):
        print(f"    {n:6d} {name}")
    print(f"  host CUDA runtime calls: {dict(on_host.most_common(10))}",
          flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fit_step_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as S
    from tpuao_torch.models import autodiff as A
    from tpuao_torch.models.pipeline import render_frame
    from tpuao_torch.ops import render as R
    from tpuao_torch.params import AOParams, CameraParams
    from tpuao_torch.utils import fixtures as F

    dev = torch.device("cuda", 0)
    card = S._card()
    forms = {"old": old_clip, "new": R._clip}
    cam = CameraParams(depth_mode="linear")
    z = torch.as_tensor(F.spheres_on_plane(1080, 1920, cam, seed=S.SEED)
                        .astype(np.float32), device=dev)
    target = render_frame(z, cam, AOParams(strength=1.8,
                                           rejection_falloff=4.0))
    steps, ref, ok = 10, None, True
    try:
        for form in ("old", "new", "new", "old"):
            R._clip = forms[form]
            A.fit_tunables(z, target, cam, lr=0.08, steps=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fitted, losses = A.fit_tunables(z, target, cam, lr=0.08,
                                            steps=steps)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
            device, by, nk = S.device_profile(
                lambda: A.fit_tunables(z, target, cam, lr=0.08, steps=2),
                calls=2)
            copies = {k: round(v / 4, 4) for k, v in by.items()
                      if k.startswith(("Memcpy", "Memset"))}
            got = (losses.cpu(), float(fitted.strength),
                   float(fitted.rejection_falloff))
            ref = got if ref is None else ref
            same = torch.equal(got[0], ref[0]) and got[1:] == ref[1:]
            ok = ok and same
            print(f"clip {form}: {ms:.2f} ms a step host, {device / 2:.3f} "
                  f"ms device, {nk / 2:.0f} device records a step, idle "
                  f"share {1 - device / 2 / ms:.3f}; copies ms a step "
                  f"{copies}; fit bit-equal to the first turn: {same} "
                  f"[{card}]", flush=True)
        x = torch.rand(64, device=dev)
        census(lambda: [x.new_tensor(0.0) for _ in range(100)],
               "100 x.new_tensor(0.0)", card)
        for form in ("old", "new"):
            R._clip = forms[form]
            census(lambda: A.fit_tunables(z, target, cam, lr=0.08, steps=1),
                   f"one 1080p fit step, clip {form}", card)
    finally:
        R._clip = forms["new"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
