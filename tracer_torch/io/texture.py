"""Texture loading with stb_image `stbi_loadf` semantics (copy of
tracer.io.texture; PIL is imported only when a file is loaded).

The reference loads the floor texture with `stbi_loadf` (main.cu:18, 54),
which promotes 8-bit LDR images to float via (byte/255)^2.2 (stb's
default ldr->hdr gamma). We reproduce that so texel values match; decode
itself is delegated to PIL (SURVEY.md §2: no need to rewrite a JPEG
decoder). A missing/broken file returns None — callers degrade to an
untextured material exactly like the reference (main.cu:19-22).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

STBI_LDR_TO_HDR_GAMMA = 2.2


def load_texture(path: str) -> Optional[np.ndarray]:
    """Load an image file to float32 [H, W, 3] in linear light, or None."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"), np.float32) / 255.0
    except Exception:
        import sys

        print(f"Failed to load texture: {path}", file=sys.stderr)
        return None
    return np.power(rgb, STBI_LDR_TO_HDR_GAMMA).astype(np.float32)
