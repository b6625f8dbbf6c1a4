"""``halo_rows_pct.sections``: the rows the program's sections rendered
beyond the rows they kept, in % of the kept rows: ``100 *
(rows_rendered / rows_kept - 1)`` of ``section_counts()`` of
``tpuao_torch.parallel.sections`` when the run's metrics are read (every
call of the run, warm-up included).  The work the halos redo; 51.85 at
8640 rows on 8 sections (13,120 rows rendered to keep 8,640).  A run off
the card, and a program without the counter, have nothing to read."""

import importlib


def read(rec):
    if rec.get("device", {}).get("platform") != "gpu":
        return None
    sections = importlib.import_module("tpuao_torch.parallel.sections")
    counts = getattr(sections, "section_counts", None)
    if counts is None:
        return None
    c = counts()
    if not c["rows_kept"]:
        return None
    return 100.0 * (c["rows_rendered"] / c["rows_kept"] - 1.0)
