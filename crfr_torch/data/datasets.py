"""Image readers for the serving commands (crfr/data/datasets.py):
``load_image`` and the ``path label`` list files.

Images decode with PIL (the pillow package); where it is not installed,
``load_image`` raises an error that names it.
"""

from __future__ import annotations

import os

import numpy as np


def load_image(path: str, size: int | None = None) -> np.ndarray:
    """An image file → (H, W, 3) uint8 RGB, bicubic-resized to ``size``²
    when given and different."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading image files needs PIL (the pillow package), "
                          "which is not installed") from e
    img = Image.open(path).convert("RGB")
    if size is not None and img.size != (size, size):
        img = img.resize((size, size), Image.BICUBIC)
    return np.asarray(img, np.uint8)


def parse_list_file(list_file: str, root: str = "") -> tuple[list[str], np.ndarray]:
    """``path label`` per line → (paths joined to ``root``, labels)."""
    paths, labels = [], []
    with open(list_file) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            p, lab = ln.rsplit(None, 1)
            paths.append(os.path.join(root, p))
            labels.append(int(lab))
    return paths, np.asarray(labels)
