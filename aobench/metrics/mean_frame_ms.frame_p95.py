"""``mean_frame_ms.frame_p95``: ``frame_ms`` (the whole window over the
frames completed in it), kept per layer in a cell where its spread from
run to run is too wide for a bound, as the host's speed sets it there."""

import pathlib

from aobench.harness import load_module

read = load_module(pathlib.Path(__file__).with_name("frame_ms.py")).read
