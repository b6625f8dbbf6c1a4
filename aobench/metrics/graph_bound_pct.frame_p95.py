"""``graph_bound_pct.frame_p95``: ``graph_bound_pct.frame``, read the
same way, in a cell whose end-to-end time of a frame is its tail,
``frame_ms_p95``."""

import pathlib

from aobench.harness import load_module

read = load_module(
    pathlib.Path(__file__).with_name("graph_bound_pct.frame.py")).read
