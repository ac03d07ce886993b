"""Image output, and image input for textures.

Render images use row 0 = bottom (GL convention); ``save_png`` flips to the
usual top-down raster order.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_numpy(image) -> np.ndarray:
    if isinstance(image, torch.Tensor):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def to_uint8(image) -> np.ndarray:
    img = _to_numpy(image)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, image) -> None:
    """Save an (H, W, 3) float image in [0, 1] (row 0 = bottom) as PNG."""
    from PIL import Image

    Image.fromarray(to_uint8(image)[::-1]).save(path)


def load_image(path: str) -> np.ndarray:
    """Load an image file as (H, W, 3) float32 in [0, 1], row 0 = top."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def save_npy(path: str, image) -> None:
    np.save(path, _to_numpy(image))
