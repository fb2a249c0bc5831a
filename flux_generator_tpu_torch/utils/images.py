"""Image output helpers (counterpart of flux_generator_tpu/utils/images.py).
PIL is imported when a file is written."""

from __future__ import annotations

import numpy as np
import torch


def _to_u8(images) -> np.ndarray:
    """(B, H, W, 3) float [0, 1] or uint8, tensor or array → uint8 array."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy() if images.is_floating_point() \
            else images.detach().cpu().numpy()
    arr = np.asarray(images)
    if arr.dtype == np.uint8:
        return arr
    return (np.clip(arr.astype(np.float32), 0, 1) * 255).astype(np.uint8)


def to_pil(images):
    """(B, H, W, 3) float [0, 1] or uint8 → list of PIL Images."""
    from PIL import Image

    return [Image.fromarray(a) for a in _to_u8(images)]


def save_image_grid(path: str, images, rows: int = 1):
    """Assemble a rows × cols grid PNG from (B, H, W, 3) float or uint8 images."""
    from PIL import Image

    arr = _to_u8(images)
    b, h, w, c = arr.shape
    cols = (b + rows - 1) // rows
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i in range(b):
        r, col = divmod(i, cols)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = arr[i]
    Image.fromarray(grid).save(path)
