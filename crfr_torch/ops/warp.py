"""Affine warp by inverse-map bilinear sampling (crfr/ops/warp.py).

The crop step of 5-point alignment: given the forward 2×3 matrix from
``ops.similarity`` (source pixel centres → template coordinates), every
output pixel samples the source at its inverse-mapped location, bilinearly,
with a constant-zero border outside the source: ``cv2.warpAffine``'s
convention (BORDER_CONSTANT 0). The four neighbours are gathers over the
batch's flattened images, so a batch of faces, each with its own matrix, is
one set of tensor operations on the images' device. ``crfr`` computes this
with XLA outside any Pallas kernel, so no hand kernel stands behind it.
"""

from __future__ import annotations

import torch

from crfr_torch.device import device_of
from crfr_torch.ops.similarity import align_matrix, align_matrix_batch, invert_affine


def _sample_bilinear(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """img (B or 1, H, W, C) f32; xs, ys (B, h, w) source coordinates →
    (B, h, w, C); one image serves every coordinate grid."""
    n, h, w, c = img.shape
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = img.reshape(n * h * w, c)
    base = (torch.arange(xs.shape[0], device=img.device) * (h * w if n > 1 else 0))[:, None, None]

    def fetch(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return v * valid[..., None].to(img.dtype)

    top = fetch(y0i, x0i) * (1 - fx) + fetch(y0i, x0i + 1) * fx
    bot = fetch(y0i + 1, x0i) * (1 - fx) + fetch(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


def warp_affine_batch(img, matrix, out_hw: tuple[int, int] = (112, 112)) -> torch.Tensor:
    """Warp (B, H, W, C) images by forward (B, 2, 3) matrices into (B, oh,
    ow, C) float32, on the images' device; a (1, H, W, C) image is warped
    by each of the B matrices (the faces of one photo)."""
    img = torch.as_tensor(img)
    inv = invert_affine(torch.as_tensor(matrix, device=img.device))
    if img.shape[0] not in (1, inv.shape[0]):
        raise ValueError(f"{img.shape[0]} images for {inv.shape[0]} matrices")
    oh, ow = out_hw
    yg, xg = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=img.device),
                            torch.arange(ow, dtype=torch.float32, device=img.device),
                            indexing="ij")
    coef = inv[:, :, :, None, None]                              # (B, 2, 3, 1, 1)
    xs = coef[:, 0, 0] * xg + coef[:, 0, 1] * yg + coef[:, 0, 2]
    ys = coef[:, 1, 0] * xg + coef[:, 1, 1] * yg + coef[:, 1, 2]
    return _sample_bilinear(img.to(torch.float32), xs, ys)


def warp_affine(img, matrix, out_hw: tuple[int, int] = (112, 112)) -> torch.Tensor:
    """Warp one (H, W, C) image by a forward 2×3 ``matrix`` into ``out_hw``."""
    img = torch.as_tensor(img)
    return warp_affine_batch(img[None], torch.as_tensor(matrix)[None], out_hw)[0]


def align_crop(img, landmarks, out_size: int = 112) -> torch.Tensor:
    """One face: landmarks → similarity solve → warp, float32."""
    img = torch.as_tensor(img)
    m = align_matrix(torch.as_tensor(landmarks, device=img.device))
    return warp_affine(img, m, (out_size, out_size))


def align_faces(image, landmarks, out_size: int = 112, template=None,
                device: str | torch.device | None = None) -> torch.Tensor:
    """One photo (H, W, C) and the (N, 5, 2) landmarks of its faces →
    (N, out_size, out_size, C) uint8 aligned crops on ``device`` (the
    image's own when it is a tensor and ``device`` is None, else CUDA):
    one batched solve and one batched warp for all faces, rounded
    ``floor(x + 0.5)`` and clipped, as ``crfr``'s ``FaceRecognizer`` and
    ``pack_aligned_list`` round them."""
    dev = device_of(image, device)
    img = torch.as_tensor(image).to(dev)
    mats = align_matrix_batch(torch.as_tensor(landmarks, dtype=torch.float32).to(dev), template)
    crops = warp_affine_batch(img[None], mats, (out_size, out_size))
    return torch.floor(crops + 0.5).clamp_(0, 255).to(torch.uint8)
