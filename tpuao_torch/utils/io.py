"""Image <-> buffer IO (counterpart of ``tpuao/utils/io.py``).

The one quantisation convention of the CLI and the serving path, shared
with the JAX package so both write and send the same bytes: clip to
[0, 1], then round-half-up to 8 bits.  Needs Pillow, imported at the call.
"""

from __future__ import annotations

import io

import numpy as np


def load_depth_image(path: str, near01: float = 0.05,
                     far01: float = 1.0) -> np.ndarray:
    """Load a grayscale image as a procedural linear-depth buffer: pixel
    intensity maps linearly to [near01, far01] (bright = far).  A test
    source (any photo becomes a depth field), not a depth decoder."""
    from PIL import Image

    img = Image.open(path).convert("L")
    a = np.asarray(img, dtype=np.float64) / 255.0
    return near01 + a * (far01 - near01)


def encode_ao_png(ao) -> bytes:
    """A [0, 1] buffer as 8-bit PNG bytes: (H, W) AO -> grayscale,
    (H, W, 3) composited colour -> RGB."""
    from PIL import Image

    a = np.clip(np.asarray(ao, dtype=np.float64), 0.0, 1.0)
    buf = io.BytesIO()
    Image.fromarray((a * 255.0 + 0.5).astype(np.uint8)).save(buf,
                                                             format="PNG")
    return buf.getvalue()


def save_ao_image(ao, path: str) -> str:
    """Save a [0, 1] AO buffer as an 8-bit grayscale PNG."""
    with open(path, "wb") as f:
        f.write(encode_ao_png(ao))
    return path


def save_composite_image(color, ao, path: str) -> str:
    """Multiply AO into an (H, W, 3) [0, 1] colour frame and save as PNG."""
    from PIL import Image

    c = np.clip(np.asarray(color, dtype=np.float64), 0.0, 1.0)
    a = np.clip(np.asarray(ao, dtype=np.float64), 0.0, 1.0)
    out = c * a[..., None]
    Image.fromarray((out * 255.0 + 0.5).astype(np.uint8)).save(path)
    return path
