"""Quality presets: the quality ladder as ``AOParams`` templates.

Counterpart of ``tpuao/models/presets.py``.  Tunables keep their defaults
and stay adjustable afterwards.

    VERY_LOW  - 2 levels, sparse 4-entry disc  (fastest)
    LOW       - 2 levels, exhaustive disc
    MEDIUM    - 3 levels, exhaustive
    HIGH      - 4 levels, exhaustive           (default)
    ULTRA     - 4 levels, exhaustive + normal-weighted falloff
"""

from __future__ import annotations

from tpuao_torch.params import AOParams

PRESETS: dict[str, AOParams] = {
    "VERY_LOW": AOParams(hierarchy_depth=2, exhaustive=False),
    "LOW": AOParams(hierarchy_depth=2, exhaustive=True),
    "MEDIUM": AOParams(hierarchy_depth=3, exhaustive=True),
    "HIGH": AOParams(hierarchy_depth=4, exhaustive=True),
    "ULTRA": AOParams(hierarchy_depth=4, exhaustive=True, use_normals=True),
}


def preset(name: str) -> AOParams:
    try:
        return PRESETS[name.upper()]
    except KeyError:
        raise ValueError(
            f"unknown quality preset {name!r}; choose from {list(PRESETS)}"
        ) from None
