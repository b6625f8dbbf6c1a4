"""One run of one cell: find its files by name, run its traffic, judge its
outputs against the plain reference, read its metrics, make the result.

Everything that belongs to one cell, configuration, traffic kind or metric
is a file of its own, found by the names in the root ``BENCHMARK.json``:

* ``workloads/<cell>.json``: the traffic's parameters, its ``kind`` and the
  limits of the check;
* ``configs/<config>.json``: the frame size, camera, tunables and path,
  and ``cards`` (1 or 4, absent 1), the cards a call's views spread over;
* ``traffic/<kind>.py``: ``run(ctx) -> record``, and where the one-frame
  reference does not fit the kind's outputs, ``reference(key, pool,
  config, workload, device, dtype=torch.float64) -> (ref, slack)``: the
  float64 (H, W) reference of the sample recorded under ``key`` and an
  allowance >= 0 a texel, or None (``judge``);
* ``metrics/<metric>.py``: ``read(record) -> value or None``.

The record a traffic module returns holds what the readers read, the
host outputs it sampled in the window under ``samples`` (``[(key, AO
array)]``, the key a pool index where the kind has no ``reference``) and
the pool of inputs under ``pool`` (``(depth (F, H, W), normals or
None)``, or what the kind's ``reference`` reads).  Record keys read by
the metric readers: ``setup_s``, ``window_s``, ``frames``,
``call_latencies_s``, ``peak_window_bytes`` (the fullest card's); in a
traced run ``host_issue_s``, ``profile`` (``profiling.summarize`` with
``frames``) and ``program_trace`` (``spans.trace_program``, None off the
card); and ``config`` and ``frame_shape``.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from dataclasses import dataclass, field

AOB = pathlib.Path(__file__).resolve().parent
ROOT = AOB.parent
# Top-level module names that must not be loaded where the result is made
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuao")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: pathlib.Path):
    """A module of the benchmark loaded from its file (names may hold
    dots, as metric names do)."""
    name = "aobench_" + path.parent.name + "_" + path.stem.replace(".", "_")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What a traffic module is given."""

    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float  # perf_counter at the start of the process's work
    shape: tuple[int, int] | None = None  # overrides the config's (tests)
    notes: list = field(default_factory=list)  # lines for standard error

    @property
    def frame_shape(self) -> tuple[int, int]:
        if self.shape is not None:
            return self.shape
        return (self.config["frame"]["height"], self.config["frame"]["width"])


def load_cell(name: str, bench: dict | None = None):
    """``(cell entry, workload file, config file)`` of a cell that
    BENCHMARK.json (or ``bench``) lists."""
    bench = bench or spec()
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no cell {name!r} in BENCHMARK.json "
                         f"(cells: {', '.join(cells)})")
    cell = cells[name]
    workload = load_json(AOB / "workloads" / f"{name}.json")
    config = load_json(AOB / "configs" / f"{cell['config']}.json")
    return cell, workload, config


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones:
    those that list the cell under ``workloads``, or list no cells."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def one_frame(key, pool, config: dict, workload: dict, device,
              dtype=None):
    """The reference of a kind without a ``reference`` of its own: the
    one-frame reference of pool frame ``key`` (``pool`` is ``(depth (F,
    H, W), normals or None)``), in float64 unless ``dtype`` says other,
    with no allowance: ``(ref, None)``."""
    import torch

    from aobench.reference import golden
    from aobench.reference.params import from_config

    params, camera = from_config(config)
    depth, normals = pool
    ref = golden.render_frame(
        depth[key].to(device), camera, params,
        None if normals is None else normals[key].to(device),
        dtype=dtype or torch.float64)
    return ref, None


def judge(samples, pool, config: dict, limit: float, device, *,
          reference=None, workload: dict | None = None,
          notes: list | None = None) -> dict:
    """The check: every sampled output ``(key, output)`` against its
    reference (``reference``, by default ``one_frame``), by the widest
    absolute gap less the reference's allowance, in float64 on
    ``device``.  A sample that never came back (``None``) or holds a value
    that is not finite fails the check by a count of its own.  Samples
    are judged in the order of their keys, each key's reference made
    once.

    Where the reference gives an allowance (``slack``, float64 (H, W),
    >= 0), a sample passes where ``max(|got - ref| - slack)`` is within
    ``limit``; the check gains ``loosened_pct``, the share of judged
    texels whose allowance exceeds ``limit``, held to the workload's
    ``check.max_loosened_pct``, and ``notes`` a line with the plain
    ``max |got - ref|``."""
    import math

    import torch

    reference = reference or one_frame
    worst = plain = 0.0
    missing = nonfinite = texels = loosened = 0
    slacked = False
    key = ref = slack = None
    for idx, out in sorted(samples, key=lambda s: s[0]):
        if out is None:
            missing += 1
            continue
        if ref is None or idx != key:
            key = idx
            ref, slack = reference(idx, pool, config, workload, device)
        got = torch.as_tensor(out).to(device=device, dtype=torch.float64)
        if got.shape != ref.shape:
            missing += 1
            continue
        err = (got - ref).abs()
        gap = float(err.max())
        if slack is not None:
            slacked = True
            plain = max(plain, gap) if math.isfinite(gap) else plain
            gap = float((err - slack).max())
            loosened += int((slack > limit).sum())
        texels += ref.numel()
        if math.isfinite(gap):
            worst = max(worst, gap)
        else:
            nonfinite += 1
    check = {"max_abs_err": {"value": worst, "limit": limit}}
    if slacked:
        if "max_loosened_pct" not in (workload or {}).get("check", {}):
            raise ValueError("a reference with an allowance needs the "
                             "workload's check.max_loosened_pct")
        check["loosened_pct"] = {
            "value": 100.0 * loosened / texels,
            "limit": workload["check"]["max_loosened_pct"]}
        if notes is not None:
            notes.append(f"plain max_abs_err {plain!r} without the "
                         f"allowance, over {texels} texels")
    check.update({"samples": {"value": len(samples) - missing - nonfinite,
                              "limit": 1},
                  "missing": {"value": missing, "limit": 0},
                  "nonfinite": {"value": nonfinite, "limit": 0}})
    return check


def correct_of(check: dict) -> bool:
    """Every number within its limit: the gap and, where the check has
    it, the loosened share at most their limits, at least ``limit``
    samples judged, no sample missing or not finite."""
    loosened = check.get("loosened_pct")
    return (check["max_abs_err"]["value"] <= check["max_abs_err"]["limit"]
            and (loosened is None or loosened["value"] <= loosened["limit"])
            and check["samples"]["value"] >= check["samples"]["limit"]
            and check["missing"]["value"] <= check["missing"]["limit"]
            and check["nonfinite"]["value"] <= check["nonfinite"]["limit"])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``tpuao_torch`` is not ``tpuao``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             shape=None,
             keep: dict | None = None) -> tuple[dict, list[str]]:
    """Run one cell once: ``(result, lines for standard error)``.  The
    result holds ``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, with ``trace`` ``breakdown``, and ``check`` last.  The
    outputs are judged by the traffic kind's ``reference`` where it
    defines one.  ``keep``, where given, receives the run's ``samples``,
    ``pool`` and ``reference`` (None for the one-frame reference)."""
    import time

    t0 = time.perf_counter() if t0 is None else t0
    bench = spec()
    cell, workload, config = load_cell(name, bench)
    ctx = Context(cell=name, workload=workload, config=config, seed=seed,
                  seconds=seconds, trace=trace, device=device, t0=t0,
                  shape=None if shape is None else tuple(shape))
    traffic = load_module(AOB / "traffic" / f"{workload['kind']}.py")
    rec = traffic.run(ctx)
    rec.setdefault("config", config)
    rec.setdefault("frame_shape", ctx.frame_shape)
    samples, pool = rec.pop("samples"), rec.pop("pool")
    reference = getattr(traffic, "reference", None)
    if keep is not None:
        keep.update(samples=samples, pool=pool, reference=reference)
    check = judge(samples, pool, config, workload["check"]["max_abs_err"],
                  device, reference=reference, workload=workload,
                  notes=ctx.notes)
    del samples, pool
    metrics = {}
    for m in metrics_for(bench, name, trace):
        value = load_module(AOB / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct_of(check), "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics,
              "device": rec["device"]}
    if trace and "profile" in rec:
        from aobench.profiling import breakdown

        result["breakdown"] = breakdown(rec["profile"])
    result["check"] = check
    lines = list(ctx.notes)
    lines += [f"check {k} {v['value']!r} limit {v['limit']!r}"
              for k, v in check.items()]
    return result, lines
