"""Host-side image decoding for the PyTorch port.

Counterpart of the two per-image functions of birefnet_tpu/loader.py:27-46,
which finetune.py reads its frames with: decode (PIL, or an array given as
is) and the native antialiased triangle resize to the model size. The JAX
module's threaded `BatchLoader` is not ported yet (ROADMAP.md, module
item 5).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from .utils import native

ImageSource = Union[str, np.ndarray]


def _decode(src: ImageSource) -> np.ndarray:
    """[H, W, 3] uint8 from a path (PIL) or an array (gray arrays are
    repeated to three channels, a fourth channel is dropped)."""
    if isinstance(src, np.ndarray):
        arr = src
        if arr.ndim == 2:
            arr = arr[..., None].repeat(3, -1)
        return np.ascontiguousarray(arr[..., :3], np.uint8)
    from PIL import Image
    with Image.open(src) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def load_frame(src: ImageSource,
               size: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Decode and triangle-resize one image to [size, size, 3] uint8.
    Returns (frame, (orig_h, orig_w))."""
    img = _decode(src)
    oh, ow = img.shape[:2]
    if (oh, ow) != (size, size):
        img = native.resize_triangle_u8(img, size, size)
    return img, (oh, ow)
