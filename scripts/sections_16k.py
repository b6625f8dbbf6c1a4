"""One frame whole (``render_frame``) and on 8 row sections
(``render_frame_sections``) on one card: peak memory beyond the input,
device time by CUDA events and by kernel (torch.profiler), and whether the
two outputs are the same bits.  The frame program is the benchmark's
``high_16k`` configuration on a dolly frame made from ``--seed``.

    python3 scripts/sections_16k.py [--shape 8640x15360] [--seed N] \
        [--out result.json]

Prints one JSON object.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def peak_mb(fn):
    """``(fn(), peak MB allocated beyond what was allocated before)``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e6


def event_ms(fn, n: int = 30) -> tuple[float, float]:
    """Device ms a call by CUDA events over ``n`` calls back to back, and
    host ms a call over the same loop."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, (time.perf_counter() - t0) * 1e3 / n


def by_kernel(fn, n: int = 10) -> dict:
    """Device busy ms a call and each kernel's and copy's launches and ms a
    call, over ``n`` profiled calls."""
    from aobench.frameloop import profile_calls

    fn()
    p = profile_calls(lambda k: fn(), n, 0, ("cuda:0",))
    ops = {**p["kernels"], **p["copies"]}
    return {"busy_ms": p["busy_s"] * 1e3 / n,
            "window_ms": p["window_s"] * 1e3 / n,
            "ops": {k: [c / n, t * 1e3 / n] for k, (c, t) in sorted(
                ops.items(), key=lambda kv: -kv[1][1])}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", default="8640x15360")
    ap.add_argument("--seed", type=int, default=2147483999)
    ap.add_argument("--sections", type=int, default=8)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch

    from aobench.device import program_params
    from aobench.scenes import dolly_pool
    from tpuao_torch.models import frame_graph
    from tpuao_torch.models.pipeline import render_frame
    from tpuao_torch.parallel.sections import render_frame_sections

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cfg = json.loads((ROOT / "aobench/configs/high_16k.json").read_text())
    cam, par = program_params(cfg)
    h, w = (int(v) for v in a.shape.split("x"))
    res = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "shape": [h, w], "sections": a.sections}
    d = dolly_pool(h, w, 1, a.seed, cfg["camera"], "cuda")[0][0]

    def whole():
        return render_frame(d, cam, par)

    def cut():
        return render_frame_sections(d, cam, par, n_sections=a.sections)

    out_w, res["whole_first_call_peak_mb"] = peak_mb(whole)
    out_s, res["sections_first_call_peak_mb"] = peak_mb(cut)
    res["bit_equal"] = bool(torch.equal(out_w, out_s))
    del out_w, out_s
    _, res["whole_second_call_peak_mb"] = peak_mb(whole)  # its capture
    _, res["whole_replay_peak_mb"] = peak_mb(whole)
    _, res["sections_steady_peak_mb"] = peak_mb(cut)
    res["whole_graph_pool_mb"] = frame_graph.pool_bytes() / 1e6
    for _ in range(2):  # in turns
        for name, fn in (("whole", whole), ("sections", cut)):
            dev_ms, host_ms = event_ms(fn)
            res.setdefault(f"{name}_event_ms", []).append(dev_ms)
            res.setdefault(f"{name}_host_loop_ms", []).append(host_ms)
    res["whole_kernels"] = by_kernel(whole)
    res["sections_kernels"] = by_kernel(cut)
    text = json.dumps(res, indent=1)
    if a.out:
        pathlib.Path(a.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
