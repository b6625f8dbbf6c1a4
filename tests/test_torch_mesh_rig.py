"""The four-device capture rig on the CPU: ``render_views_sharded`` over
``make_mesh(devices=["cpu"] * 4)`` (2 views a device) against the float64
golden, its spans (``ao_scatter``, ``ao_gather``) and counters
(``mesh_counts``), and the CUDA graph cache's per-card pool bound.

The same path over four distinct cards runs in the benchmark's cell
``high_1080p_x4.rig8`` (``aobench/tests/test_aobench_mesh_rig.py -m gpu``).
No JAX here: the port is held to its own golden.
"""

import types

import numpy as np
import pytest
import torch

from tpuao_torch.golden import render_frame_golden
from tpuao_torch.models import frame_graph
from tpuao_torch.params import AOParams, CameraParams
from tpuao_torch.parallel import sharding as SH
from tpuao_torch.utils import fixtures as F
from tpuao_torch.utils import trace

H, W = 64, 128
CAM = CameraParams(reversed_z=True, depth_mode="hardware")
MESH4 = SH.make_mesh(devices=["cpu"] * 4)


def rig(n: int) -> np.ndarray:
    """(n, H, W) float32 reversed-Z hardware depth, one scene a camera."""
    return np.stack([
        F.to_hardware_depth(F.spheres_on_plane(H, W, CAM, n_spheres=4,
                                               seed=s), CAM)
        for s in range(n)]).astype(np.float32)


@pytest.fixture
def counts():
    SH._clear()
    yield SH
    SH._clear()


@pytest.fixture
def tracing():
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.take()


@pytest.mark.parametrize("n", [8, 5])
def test_each_view_is_its_own_golden_frame_and_the_one_batch_call(n):
    """View v of the result is view v's frame alone, in view order: within
    1e-3 of its float64 golden, and bit-equal to the one-batch call (an
    uneven count pads to 8 and crops back)."""
    z = rig(n)
    params = AOParams()
    got = SH.render_views_sharded(z, CAM, params, mesh=MESH4)
    assert got.shape == (n, H, W) and got.dtype == torch.float32
    assert got.device == torch.device("cpu")
    for v in range(n):
        want = render_frame_golden(z[v], CAM, params, device="cpu")
        assert float((got[v].double() - want).abs().max()) <= 1e-3, v
    one = SH.render_views_sharded(z, CAM, params, device="cpu")
    assert torch.equal(got, one)


@pytest.mark.parametrize("n", [8, 5])
def test_one_mesh_call_records_its_scatter_and_gather(tracing, n):
    """One top-level ``ao_entry.render_views`` of the call's frames, and
    under it, for each device in mesh order, one ``ao_scatter`` then that
    device's ``ao_entry.render_frame``; then one ``ao_gather``."""
    SH.render_views_sharded(rig(n), CAM, mesh=MESH4)
    spans = tracing.take()["spans"]
    top = [i for i, r in enumerate(spans) if r.parent == -1]
    assert top == [0]
    assert spans[0].name == "ao_entry.render_views"
    assert spans[0].frames == n
    children = [r.name for r in spans if r.parent == 0]
    assert children == ["ao_scatter", "ao_entry.render_frame"] * 4 + [
        "ao_gather"]
    for r in spans[1:]:
        assert spans[0].start_ns <= r.start_ns <= r.end_ns <= spans[0].end_ns


def test_tracing_off_records_nothing():
    trace.take()
    SH.render_views_sharded(rig(8), CAM, mesh=MESH4)
    assert trace.take()["spans"] == []


@pytest.mark.parametrize("mesh,shards", [(MESH4, 4), (None, 1),
                                         (["cpu"] * 2, 2)])
def test_mesh_counts_calls_frames_and_shards(counts, mesh, shards):
    """Every ``render_views_sharded`` call counts its views and shards; a
    mesh that names one device several times copies no byte between
    devices."""
    z = rig(5)
    SH.render_views_sharded(z, CAM, mesh=mesh, device="cpu")
    SH.render_views_sharded(z[:3], CAM, mesh=mesh, device="cpu")
    assert counts.mesh_counts() == {"calls": 2, "frames": 8,
                                    "shards": 2 * shards, "peer_bytes": 0}
    counts._clear()
    assert counts.mesh_counts() == dict.fromkeys(
        ("calls", "frames", "shards", "peer_bytes"), 0)


def test_peer_bytes_count_copies_between_distinct_devices(counts):
    """``_to`` counts the bytes of a copy that lands on another device
    (here the meta device, which holds no data), and none where the
    tensor stays where it is."""
    x = torch.zeros(3, 5, dtype=torch.float32)
    assert SH._to(x, "cpu") is x
    y = SH._to(x, "meta")
    assert y.device == torch.device("meta")
    assert counts.mesh_counts()["peer_bytes"] == 60
    SH._to(x.double(), "meta")
    assert counts.mesh_counts()["peer_bytes"] == 60 + 120


@pytest.fixture
def graphs():
    frame_graph._clear()
    yield frame_graph
    frame_graph._clear()


@pytest.mark.parametrize("case", ["cards apart", "within a card"])
def test_graph_pool_bound_is_per_card(graphs, monkeypatch, case):
    """The pools on one card are held to that card's bound alone: a card
    filling its share evicts its own least recent graphs and never those
    of another card; ``pool_bytes`` stays the sum over every card."""
    monkeypatch.setattr(graphs, "_bound", lambda device: 100)
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)

    def insert(name, dev, nbytes):
        graphs._insert((dev, name), types.SimpleNamespace(nbytes=nbytes),
                       dev)

    def held():
        return [k[1] for k in graphs._entries]

    if case == "cards apart":
        insert("a0", c0, 60)
        insert("a1", c1, 60)
        insert("b0", c0, 40)
        insert("b1", c1, 40)
        # 100 a card: each card at its bound, none evicted
        assert held() == ["a0", "a1", "b0", "b1"]
        assert graphs.pool_bytes() == 200
        insert("c1", c1, 30)  # card 1 over: its least recent goes
        assert held() == ["a0", "b0", "b1", "c1"]
        assert graphs._seen[(c1, "a1")] == "evicted"
        assert (c0, "a0") not in graphs._seen
    else:
        insert("a0", c0, 60)
        insert("a1", c1, 90)
        insert("b0", c0, 50)  # 110 on card 0: "a0" goes, card 1 untouched
        assert held() == ["a1", "b0"]
        insert("c0", c0, 500)  # above the bound alone: the newest stays
        assert held() == ["a1", "c0"]
        assert graphs.pool_bytes() == 590
        assert [k[1] for k, s in graphs._seen.items()
                if s == "evicted"] == ["a0", "b0"]
