"""The frozen count of the bytes a mesh call copies between cards.

``render_views_sharded`` over a mesh of ``cards`` distinct cards pads the
views to a multiple of the cards (the last view replicated), keeps the
first card's share where the inputs are and copies each other card's
share there: the depth (H, W) float32 of each view, and its normals
(H, W, 3) float32 where the configuration reads them.  Each other card's
float32 AO (H, W) comes back to the first card for the gather, padding
included (the crop follows the gather).  Kept here, apart from the
program, so that no change to the program can move the count that
``peer_link_pct.mesh`` divides by.
"""

from __future__ import annotations

FLOAT32 = 4


def peer_bytes_per_call(h: int, w: int, views: int, cards: int,
                        use_normals: bool) -> int:
    """Bytes one call of ``views`` (H, W) frames over ``cards`` distinct
    cards copies between cards, inputs and outputs."""
    per_card = -(-views // cards)
    moved = (cards - 1) * per_card
    planes = 1 + (3 if use_normals else 0) + 1  # depth, normals, AO
    return moved * h * w * FLOAT32 * planes
