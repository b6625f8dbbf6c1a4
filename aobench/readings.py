"""The two readings a check's limit is set from, on the chip, in one
process: the program's widest gap from the reference over many seeds
(each a whole run of the cell, at its own size and load, with a short
window), and the control's (``control.py``) on the first few of them,
on the inputs and sample keys of that seed's run.  Both take the traffic
kind's ``reference`` where it defines one; where it gives an allowance, a
row also holds ``loosened_pct``.

    python3 aobench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 --control 3 [--out aobench/out/readings.jsonl]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=3,
                    help="seeds (the first ones) the control runs on")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", help="HxW in place of the config's (tests)")
    ap.add_argument("--out", default=str(ROOT / "aobench" / "out" /
                                         "readings.jsonl"))
    a = ap.parse_args(argv)
    from aobench import harness
    from aobench.control import control_gap

    shape = (tuple(int(v) for v in a.shape.split("x")) if a.shape
             else None)
    _, wl, cfg = harness.load_cell(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    out = pathlib.Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for k, seed in enumerate(seeds):
        run = {}
        res, _ = harness.run_cell(a.workload, seed, a.seconds, False,
                                  device=a.device, shape=shape, keep=run)
        row = {"cell": a.workload, "seed": seed, "correct": res["correct"],
               "program": res["check"]["max_abs_err"]["value"],
               "attempted": res["attempted"], "failed": res["failed"]}
        if "loosened_pct" in res["check"]:
            row["loosened_pct"] = res["check"]["loosened_pct"]["value"]
        if k < a.control:
            row["control"] = control_gap(
                run["pool"], cfg, [key for key, _ in run["samples"]],
                a.device, workload=wl, reference=run["reference"])
        del run
        rows.append(row)
        print(json.dumps(row), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
    prog = [r["program"] for r in rows]
    ctrl = [r["control"] for r in rows if "control" in r]
    print(json.dumps({"cell": a.workload, "seeds": len(rows),
                      "all_correct": all(r["correct"] for r in rows),
                      "program_max": max(prog),
                      "control_min": min(ctrl) if ctrl else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
