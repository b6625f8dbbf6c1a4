"""AO buffer -> PNG bytes (counterpart of ``tpuao/utils/io.py``'s encoder).

The one quantisation convention of the serving path, shared with the JAX
package so both servers send the same bytes: clip to [0, 1], then
round-half-up to 8 bits.  Needs Pillow, imported at the call.
"""

from __future__ import annotations

import io

import numpy as np


def encode_ao_png(ao) -> bytes:
    """A [0, 1] buffer as 8-bit PNG bytes: (H, W) AO -> grayscale,
    (H, W, 3) composited colour -> RGB."""
    from PIL import Image

    a = np.clip(np.asarray(ao, dtype=np.float64), 0.0, 1.0)
    buf = io.BytesIO()
    Image.fromarray((a * 255.0 + 0.5).astype(np.uint8)).save(buf,
                                                             format="PNG")
    return buf.getvalue()
