"""Run one cell of the benchmark once and print its result.

    python3 aobench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Each run is a new process: it loads, warms up, measures for ``--seconds``
and prints one JSON object as the last line of standard output, with the
numbers it checked, each beside its limit, as the last lines of standard
error.  It exits with another code than 0, and prints no result, where the
cell's chips in ``BENCHMARK.json`` differ from its configuration's
``cards`` (checked before it looks for a card), where the card or the
program is missing, where the cell asks for more cards than there are, or
where a JAX module was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "aobench" / "out"


def _environment() -> None:
    """Caches at fixed paths inside the checkout, and no JAX through a
    library that would load it by itself."""
    cache = OUT / "cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    from aobench import harness

    cell, _, config = harness.load_cell(args.workload)
    cards = config.get("cards", 1)
    if cell["chips"] != cards:
        print(f"aobench: {args.workload} asks for {cell['chips']} chips, its "
              f"configuration {config['name']} for {cards} cards",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("aobench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"aobench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), device="cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"aobench: loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
