"""What the benchmark loads: no ``jax``, ``jaxlib``, ``flax`` or ``tpuao``
(top-level names compared whole, so ``tpuao_torch`` passes), and a
reference that loads nothing of the program."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
AOB = ROOT / "aobench"

HARNESS = f"""
import json, pathlib, sys
sys.path.insert(0, {str(ROOT)!r})
from aobench import harness, control, profiling, work, stats
aob = pathlib.Path({str(AOB)!r})
for kind in ("traffic", "metrics"):
    for p in sorted((aob / kind).glob("*.py")):
        harness.load_module(p)
import aobench.readings
from aobench.reference import golden, params
harness.run_cell("high_1080p.stream", 3, 0.2, False, device="cpu",
                 shape=(64, 128))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from aobench.reference import golden, params
import aobench.control
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(HARNESS)
    assert not names & {"jax", "jaxlib", "flax", "tpuao"}, names
    assert "tpuao_torch" in names  # a run drives the port


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "tpuao", "tpuao_torch"}


def test_forbidden_names_compare_whole(monkeypatch):
    from aobench import harness

    monkeypatch.setitem(sys.modules, "tpuao_torch_x", sys)
    assert "tpuao" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpuao.params", sys)
    assert harness.forbidden_modules() == ["tpuao"]
