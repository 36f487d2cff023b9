"""insightface ``.bin`` verification sets (lfw.bin, cfp_fp.bin, agedb_30.bin;
crfr/data/bins.py).

The format: a pickle of ``(bins, issame_list)``, ``bins`` 2N encoded images
(JPEG bytes, pair i at 2i and 2i + 1; some dumps hold raw arrays) and
``issame_list`` N booleans. Unpickling can run code, so read only files from
a source you trust. Images decode with PIL (the pillow package); where it is
not installed, reading or writing a set raises an error that names it.
"""

from __future__ import annotations

import io
import pickle

import numpy as np
import torch


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(".bin verification sets are JPEG images: decoding and "
                          "encoding them needs PIL (the pillow package), which is not "
                          "installed") from e
    return Image


def load_bin(path: str, image_size: int = 112) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (img1 (N, S, S, 3) uint8, img2 (N, S, S, 3) uint8, issame (N,) bool),
    each image bicubic-resized to ``image_size``² where it differs."""
    image = _pil()
    with open(path, "rb") as f:
        bins, issame = pickle.load(f, encoding="bytes")
    n = len(issame)
    if len(bins) != 2 * n:
        raise ValueError(f"{path}: {len(bins)} images for {n} pairs")

    def decode(b) -> np.ndarray:
        if isinstance(b, np.ndarray):
            arr = b
        else:
            arr = np.asarray(image.open(io.BytesIO(bytes(b))).convert("RGB"))
        if arr.shape[:2] != (image_size, image_size):
            arr = np.asarray(image.fromarray(arr).resize((image_size, image_size),
                                                         image.BICUBIC))
        return arr.astype(np.uint8)

    img1 = np.stack([decode(bins[2 * i]) for i in range(n)])
    img2 = np.stack([decode(bins[2 * i + 1]) for i in range(n)])
    return img1, img2, np.asarray(issame, bool)


def save_bin(path: str, img1: np.ndarray, img2: np.ndarray, issame: np.ndarray,
             quality: int = 95) -> None:
    """Write pairs in the insightface format, each image as a JPEG."""
    image = _pil()
    bins = []
    for a, b in zip(img1, img2):
        for arr in (a, b):
            buf = io.BytesIO()
            image.fromarray(np.asarray(arr, np.uint8)).save(buf, format="JPEG",
                                                            quality=quality)
            bins.append(buf.getvalue())
    with open(path, "wb") as f:
        pickle.dump((bins, list(np.asarray(issame, bool))), f)


def evaluate_bin(path: str, extract_fn, batch_size: int = 256, image_size: int = 112,
                 n_folds: int = 10, far_targets=(1e-3, 1e-2),
                 device: str | torch.device = "cuda"):
    """A ``.bin`` set through ``extract_fn`` (raw uint8 batch → (B, D)
    embeddings) and the n-fold verification protocol on ``device``.

    The batch is ``min(batch_size, N rounded up to 8)``, the last one padded
    with zero images whose rows are dropped, as ``crfr`` batches it."""
    from crfr_torch.eval.verification import evaluate_verification

    img1, img2, issame = load_bin(path, image_size)
    batch_size = min(batch_size, max(-(-len(img1) // 8) * 8, 8))

    def embed_all(imgs: np.ndarray) -> np.ndarray:
        outs = []
        for s in range(0, len(imgs), batch_size):
            chunk = imgs[s:s + batch_size]
            pad = batch_size - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            e = torch.as_tensor(extract_fn(chunk)).float().cpu().numpy()
            outs.append(e[:batch_size - pad])
        return np.concatenate(outs)

    return evaluate_verification(embed_all(img1), embed_all(img2), issame, n_folds,
                                 far_targets, device=device)
