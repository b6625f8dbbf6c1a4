"""Multi-device execution of the PyTorch port (counterpart of tpuao.parallel).

``sharding`` renders views over a mesh of devices, ``spatial`` one frame in
row bands with halo rows exchanged between neighbours, ``grid`` views x row
bands on a 2-D grid of devices; ``sections`` one frame in row sections
rendered one after another on one device, for a bounded peak memory.
"""

from tpuao_torch.parallel.grid import (  # noqa: F401
    make_grid_mesh,
    render_views_spatial,
)
from tpuao_torch.parallel.sections import (  # noqa: F401
    render_frame_sections,
    render_frame_sections_fused,
    section_plan,
    sections_fused_fn,
)
from tpuao_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    render_sequences_temporal_sharded,
    render_views,
    render_views_sharded,
)
from tpuao_torch.parallel.spatial import (  # noqa: F401
    HALO_ROWS,
    halo_extend_rows,
    make_row_mesh,
    render_frame_spatial,
    stencil_halo_rows,
)
