"""Per-launch tile rows of the port's CUDA kernels.

Counterpart of ``tpuao/utils/xla_opts.py``.  There the one launch lever
of a ``tpuao`` program is XLA's scoped-VMEM budget, a hand-measured value
per frame-size class with a table of per-shape overrides that
``utils/autotune.py`` fills.  Here the lever is the texels a thread (the
tile's rows, ``nt``) of each launch of the three tiled kernels that the
frame programs run: the depth-only and normals render (``csrc/render.cu``),
the upsample step (``csrc/upsample.cu``) and the fused step
(``csrc/fused.cu``).  Each launcher picks ``nt`` by a rule of its own
(``rule_nt``, written by hand from the card's 132 SMs) unless its ``nt``
argument forces an instance; the wrappers (``ops/kernels.py``) pass
``tile_rows(...)``, which is 0 -- the rule -- unless the table holds a
value for that exact launch.

The key is the launch, not the frame: ``(kernel, batch, h, w)`` with the
kernel named as its wrapper is and (h, w) the level the kernel reads (the
lo level of a chain step).  One 1080p frame's five launches span levels
from 68 x 120 to 544 x 960, and every frame program that makes a launch of
that key -- a frame, a batch of views, a band, a section -- takes the
table's value.  Tile rows change no result (ROADMAP queue 2's shared
contract): only the time.

    import tpuao_torch.utils.launch_opts as L
    L.set_tuned_tiles("fused_render_upsample_step", 1, 544, 960, 3)
    L.tile_rows("fused_render_upsample_step", 1, 544, 960)   # 3
    L.tile_rows("fused_render_upsample_step", 4, 544, 960)   # 0: the rule

``utils/autotune.tune_frame`` sweeps the values on the card and fills the
table; ``save_tuned`` / ``load_tuned`` keep it per device kind.
"""

from __future__ import annotations

# The instances each launcher has (the template arguments its switch
# reaches): a value outside these is refused here and by the launcher.
VALID_NT: dict[str, tuple[int, ...]] = {
    "render_ao_level": (4, 2, 1),
    "render_ao_level_normals": (1,),  # render.cu's static_assert
    "blur_upsample_step": (3, 2, 1),
    "fused_render_upsample_step": (3, 2, 1),
}

SMS = 132  # H100 SXM: the rules' "every SM gets a block" (csrc/ bakes it in)

# Tuned per-launch values: (kernel, batch, h, w) -> nt.  Filled by
# utils.autotune (a sweep on the card beats the hand-written rule for a
# launch nobody timed by hand); consulted by tile_rows.
_TUNED: dict[tuple[str, int, int, int], int] = {}
_GEN = 0  # bumped by every change of _TUNED: a graph of a frame reads it


def generation() -> int:
    """A count of the table's changes (``models/frame_graph`` keys its
    graphs on it: a changed table captures anew)."""
    return _GEN


def _changed() -> None:
    global _GEN
    _GEN += 1


def _key(kernel: str, batch: int, h: int, w: int) -> tuple[str, int, int,
                                                             int]:
    if kernel not in VALID_NT:
        raise ValueError(f"kernel {kernel!r} takes no tile rows; one of "
                         f"{sorted(VALID_NT)}")
    return str(kernel), int(batch), int(h), int(w)


def set_tuned_tiles(kernel: str, batch: int, h: int, w: int,
                    nt: int) -> None:
    """Make every launch of ``kernel`` over ``batch`` frames of (h, w) run
    at ``nt`` texels a thread; ``nt`` must be one of ``VALID_NT[kernel]``
    (``ValueError`` otherwise)."""
    key = _key(kernel, batch, h, w)
    if int(nt) not in VALID_NT[kernel]:
        raise ValueError(f"{kernel} has no instance at nt={nt}; one of "
                         f"{VALID_NT[kernel]}")
    _TUNED[key] = int(nt)
    _changed()


def clear_tuned_tiles() -> None:
    _TUNED.clear()
    _changed()


def restore_tuned_tiles(prior: dict) -> None:
    """Put back table entries saved as ``{key: nt or None}`` (None: no
    entry)."""
    for key, nt in prior.items():
        if nt is None:
            _TUNED.pop(key, None)
        else:
            _TUNED[key] = nt
    _changed()


def tile_rows(kernel: str, batch: int, h: int, w: int) -> int:
    """Texels a thread for this launch: the tuned value, or 0, which asks
    the launcher for its own rule (``rule_nt``)."""
    return _TUNED.get((kernel, int(batch), int(h), int(w)), 0)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rule_nt(kernel: str, batch: int, h: int, w: int, h0: int | None = None,
            w0: int | None = None) -> int:
    """The texels a thread that the launcher picks when ``tile_rows`` is 0
    (the C rules ``render_rule_nt`` in ``csrc/render.cu`` and ``chain_nt``
    in ``csrc/chain_step.cuh``, which the card holds this equal to):

    * the depth-only render: the most of 4, 2, 1 whose grid of 64 x 8*nt
      blocks still gives each of the 132 SMs one;
    * the normals render: 1;
    * a chain step from (h, w) to the (h0, w0) crop (default the whole
      2h x 2w): 3 where blocks of (8*nt - 3) x 61 lo texels make two full
      waves of three blocks an SM, else 2 where every SM gets a block,
      else 1.
    """
    _key(kernel, batch, h, w)
    if kernel == "render_ao_level_normals":
        return 1
    if kernel == "render_ao_level":
        for nt in (4, 2):
            if _cdiv(w, 64) * _cdiv(h, 8 * nt) * batch >= SMS:
                return nt
        return 1
    h0 = 2 * h if h0 is None else h0
    w0 = 2 * w if w0 is None else w0

    def blocks(nt):
        return (_cdiv(_cdiv(w0, 2), 61) * _cdiv(_cdiv(h0, 2), 8 * nt - 3)
                * batch)

    if blocks(3) >= 2 * 3 * SMS:
        return 3
    return 2 if blocks(2) >= SMS else 1
