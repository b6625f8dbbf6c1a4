"""Per-launch tile rows of the port's CUDA kernels.

Counterpart of ``tpuao/utils/xla_opts.py``.  There the one launch lever
of a ``tpuao`` program is XLA's scoped-VMEM budget, a hand-measured value
per frame-size class with a table of per-shape overrides that
``utils/autotune.py`` fills.  Here the lever is the texels a thread (the
tile's rows, ``nt``) of each launch of the three tiled kernels that the
frame programs run: the depth-only and normals render (``csrc/render.cu``),
the upsample step (``csrc/upsample.cu``) and the fused step
(``csrc/fused.cu``).  This module decides it for every launch:
``nt_for`` gives the table's value for the launch if it holds one, else
the rule (``rule_nt``, written by hand from the card's ``SMS``), and the
wrappers (``ops/kernels.py``) pass that instance to the launchers, which
take it as given and refuse a value they have no instance for.

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
    L.tile_rows("fused_render_upsample_step", 4, 544, 960)   # 0: no entry
    L.nt_for("fused_render_upsample_step", 4, 544, 960)      # 3: the rule

``utils/autotune.tune_frame`` sweeps the values on the card and fills the
table; ``save_tuned`` / ``load_tuned`` keep it per device kind.
"""

from __future__ import annotations

# The instances each launcher has (the template arguments its switch
# reaches): a value outside these, 0 included, is refused here and by the
# launcher.
VALID_NT: dict[str, tuple[int, ...]] = {
    "render_ao_level": (4, 2, 1),
    "render_ao_level_normals": (1,),  # render.cu's static_assert
    "blur_upsample_step": (3, 2, 1),
    "fused_render_upsample_step": (3, 2, 1),
}

SMS = 132  # H100 SXM: the package's one SM count (the rules' waves)

# Tuned per-launch values: (kernel, batch, h, w) -> nt.  Filled by
# utils.autotune (a sweep on the card beats the hand-written rule for a
# launch nobody timed by hand); consulted by nt_for and tile_rows.
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
    """The table's texels a thread for this launch, or 0 where it holds
    none."""
    return _TUNED.get((kernel, int(batch), int(h), int(w)), 0)


def nt_for(kernel: str, batch: int, h: int, w: int, h0: int | None = None,
           w0: int | None = None) -> int:
    """Texels a thread of this launch, the instance its launcher runs: the
    table's value for ``(kernel, batch, h, w)``, else ``rule_nt``."""
    return tile_rows(kernel, batch, h, w) or rule_nt(kernel, batch, h, w,
                                                     h0, w0)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rule_nt(kernel: str, batch: int, h: int, w: int, h0: int | None = None,
            w0: int | None = None) -> int:
    """The texels a thread of a launch the table holds nothing for:

    * the depth-only render: the most of 4, 2, 1 whose grid of 64 x 8*nt
      blocks still gives each of the ``SMS`` SMs one (fewer halo rows
      staged a texel);
    * the normals render: 1, which measured faster than 2 or 4;
    * a chain step from (h, w) to the (h0, w0) crop (default the whole
      2h x 2w): 3 where blocks of (8*nt - 3) x 61 lo texels make two full
      waves of three blocks an SM, else 2 where every SM gets a block,
      else 1 (at one wave and a bit, the 1080p fused step 1->0, 3
      measured slower than 2: the last wave runs almost empty).
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
