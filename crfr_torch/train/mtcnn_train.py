"""MTCNN cascade training on rendered faces (crfr/train/mtcnn_train.py).

No pretrained MTCNN weights exist offline, so faces are rendered
procedurally with their boxes and all five landmarks known by
construction, and P/R/O-net train briefly on crops sampled from those
scenes; ``pipeline.FaceRecognizer``'s detect → align → embed then runs on
scenes the cascade has never seen. The renderer and the sampler are numpy
copies of ``crfr``'s and draw the same arrays from the same generator; the
crops of a scene go through the port's ``crop_resize`` (one launch of the
resize kernel's crop form for all of them, normalized on the device). Targets follow the canonical MTCNN
conventions the host decode expects: box deltas normalized by the crop
side (applied as ``x1 += dx1·w``), landmarks relative to the crop box.

Each net takes one Adam step a scene batch (``torch.optim.Adam`` at betas
(0.9, 0.999), eps 1e-8: optax's ``adam`` defaults, the same update). The
loss: binary cross-entropy on the face probability with eps 1e-6, plus 0.5
× the box-regression squared error summed over positives and divided by
their count, plus for O-net 0.5 × the same of the landmarks. Nothing here
draws random numbers on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from crfr_torch.device import resolve_device
from crfr_torch.models.mtcnn import MTCNN, crop_resize

# ---------------------------------------------------------------------------
# Procedural face renderer: geometry known by construction
# ---------------------------------------------------------------------------

# Canonical landmark layout in box-relative coords (eyes, nose, mouth pair),
# close to the 112×112 alignment template's proportions.
_LMK_REL = np.asarray([
    [0.315, 0.46], [0.685, 0.46],      # eyes
    [0.50, 0.64],                      # nose tip
    [0.35, 0.82], [0.65, 0.82],        # mouth corners
], np.float32)


def render_face(rng: np.random.Generator, s: int) -> tuple[np.ndarray, np.ndarray]:
    """→ (face crop (s, s, 3) float32 [0, 255], landmarks (5, 2) crop coords):
    an elliptical skin patch, dark elliptical eyes, a nose wedge and a mouth
    bar."""
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    skin = np.asarray([198, 160, 122], np.float32) + rng.normal(0, 12, 3)
    img = np.zeros((s, s, 3), np.float32)
    cx, cy, rx, ry = 0.5, 0.52, 0.42, 0.48
    head = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
    img[head] = skin * rng.uniform(0.9, 1.1)
    # landmark jitter, shared by the face: the constellation shifts a bit
    lmk = (_LMK_REL + rng.normal(0, 0.012, _LMK_REL.shape)).astype(np.float32)
    for ex, ey in lmk[:2]:
        m = ((xx - ex) / 0.075) ** 2 + ((yy - ey) / 0.045) ** 2 <= 1.0
        img[m] = rng.uniform(15, 60)
    nx, ny = lmk[2]
    m = (np.abs(xx - nx) <= (yy - (ny - 0.16)) * 0.28) & (yy <= ny) & \
        (yy >= ny - 0.16)
    img[m] = skin * 1.12
    (mx1, my1), (mx2, my2) = lmk[3], lmk[4]
    m = (xx >= mx1) & (xx <= mx2) & (np.abs(yy - 0.5 * (my1 + my2)) <= 0.035)
    img[m] = np.asarray([150, 50, 50], np.float32) * rng.uniform(0.8, 1.2)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255), lmk * s


def _smooth_background(rng: np.random.Generator, size: int) -> np.ndarray:
    coarse = rng.uniform(0, 255, (6, 6, 3))
    ys = np.linspace(0, 5, size)
    y0 = np.floor(ys).astype(int).clip(0, 4)
    fy = (ys - y0)
    a = coarse[y0] * (1 - fy)[:, None, None] + coarse[y0 + 1] * fy[:, None, None]
    b = a[:, y0] * (1 - fy)[None, :, None] + a[:, y0 + 1] * fy[None, :, None]
    return b.astype(np.float32)


@dataclass
class Scene:
    image: np.ndarray          # (H, W, 3) float32 [0, 255]
    box: np.ndarray            # (4,) x1 y1 x2 y2
    landmarks: np.ndarray      # (5, 2) absolute coords


def render_scene(rng: np.random.Generator, size: int = 160,
                 face_range: tuple[int, int] = (48, 112)) -> Scene:
    img = _smooth_background(rng, size)
    s = int(rng.integers(*face_range))
    x1 = int(rng.integers(0, size - s + 1))
    y1 = int(rng.integers(0, size - s + 1))
    face, lmk = render_face(rng, s)
    # blend inside the head ellipse only, so the box edge is no rectangle cue
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    mask = (((xx - 0.5) / 0.46) ** 2 + ((yy - 0.52) / 0.5) ** 2 <= 1.0
            )[..., None].astype(np.float32)
    img[y1:y1 + s, x1:x1 + s] = (mask * face
                                 + (1 - mask) * img[y1:y1 + s, x1:x1 + s])
    return Scene(img, np.asarray([x1, y1, x1 + s, y1 + s], np.float32),
                 lmk + np.asarray([x1, y1], np.float32))


def iou(a: np.ndarray, b: np.ndarray) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ar_a = (a[2] - a[0]) * (a[3] - a[1])
    ar_b = (b[2] - b[0]) * (b[3] - b[1])
    return float(inter / max(ar_a + ar_b - inter, 1e-9))


def sample_crops(rng: np.random.Generator, scene: Scene, out_size: int, n_pos: int,
                 n_neg: int, device: str | torch.device = "cuda"):
    """IoU-sampled training crops from one scene → (crops (n, out, out, 3)
    float32 normalized on ``device``, cls (n,), reg (n, 4), lmk (n, 10)
    numpy); reg and lmk are zero for negatives (masked out of the loss).
    Exactly ``n_pos`` positives (the GT box itself after 30·n_pos misses)
    and ``n_neg`` negatives."""
    g = scene.box
    gs = g[2] - g[0]
    size = scene.image.shape[0]
    boxes, cls = [], []
    tries = 0
    while sum(cls) < n_pos:
        tries += 1
        if tries > n_pos * 30:
            boxes.append(g.copy())
            cls.append(1)
            continue
        side = gs * rng.uniform(0.85, 1.2)
        cx = 0.5 * (g[0] + g[2]) + rng.uniform(-0.15, 0.15) * gs
        cy = 0.5 * (g[1] + g[3]) + rng.uniform(-0.15, 0.15) * gs
        b = np.asarray([cx - side / 2, cy - side / 2,
                        cx + side / 2, cy + side / 2], np.float32)
        if iou(b, g) >= 0.6:
            boxes.append(b)
            cls.append(1)
    n_have_pos = len(boxes)
    tries = 0
    while (len(boxes) - n_have_pos) < n_neg:
        tries += 1
        side = rng.uniform(12, size * 0.8)
        x1 = rng.uniform(0, size - side)
        y1 = rng.uniform(0, size - side)
        b = np.asarray([x1, y1, x1 + side, y1 + side], np.float32)
        if iou(b, g) < 0.25 or tries > n_neg * 30:
            boxes.append(b)
            cls.append(0)
    boxes = np.asarray(boxes, np.float32)
    cls = np.asarray(cls, np.float32)
    image = torch.from_numpy(np.ascontiguousarray(scene.image, np.float32))
    crops = crop_resize(image.to(resolve_device(device)), boxes, out_size)
    side = boxes[:, 2] - boxes[:, 0]
    reg = np.stack([(g[0] - boxes[:, 0]) / side,
                    (g[1] - boxes[:, 1]) / side,
                    (g[2] - boxes[:, 2]) / side,
                    (g[3] - boxes[:, 3]) / side], 1).astype(np.float32)
    lmk = np.concatenate([
        (scene.landmarks[None, :, 0] - boxes[:, 0:1]) / side[:, None],
        (scene.landmarks[None, :, 1] - boxes[:, 1:2]) / side[:, None],
    ], 1).astype(np.float32)                      # (n, 10) = x1..x5, y1..y5
    neg = cls == 0
    reg[neg] = 0
    lmk[neg] = 0
    return crops, cls, reg, lmk


# ---------------------------------------------------------------------------
# Per-net training
# ---------------------------------------------------------------------------


def mtcnn_loss(out: tuple[torch.Tensor, ...], cls_t: torch.Tensor, reg_t: torch.Tensor,
               lmk_t: torch.Tensor | None = None) -> torch.Tensor:
    """BCE on the face probability + 0.5 × the positives' box MSE (+ 0.5 ×
    their landmark MSE when ``lmk_t`` is given), each summed and divided by
    the number of positives (at least 1)."""
    prob = out[0].reshape(-1)
    reg = out[1].reshape(out[1].shape[0], -1)
    eps = 1e-6
    ce = -torch.mean(cls_t * torch.log(prob + eps) + (1 - cls_t) * torch.log(1 - prob + eps))
    pos = cls_t[:, None]
    n_pos = torch.clamp(cls_t.sum(), min=1.0)
    loss = ce + 0.5 * (torch.sum(pos * torch.square(reg - reg_t)) / n_pos)
    if lmk_t is not None:
        loss = loss + 0.5 * (torch.sum(pos * torch.square(out[2] - lmk_t)) / n_pos)
    return loss


def make_step(net: nn.Module, lr: float, with_lmk: bool) -> Callable:
    """``step(x, cls, reg, lmk) → loss``: one Adam step of ``net`` on a crop
    batch (x normalized NHWC on the net's device; the targets numpy or
    tensors). The optimizer lives in the closure."""
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    dev = next(net.parameters()).device

    def step(x, cls_t, reg_t, lmk_t) -> torch.Tensor:
        t = [torch.as_tensor(a, dtype=torch.float32).to(dev) for a in (cls_t, reg_t, lmk_t)]
        net.train()
        loss = mtcnn_loss(net(x), t[0], t[1], t[2] if with_lmk else None)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def train_mtcnn_synthetic(mtcnn: MTCNN, steps: int = 250, batch_scenes: int = 8,
                          lr: float = 2e-3, seed: int = 0,
                          scene_size: int = 160) -> dict[str, float]:
    """Train ``mtcnn``'s P/R/O-net in place on rendered faces, on its device.

    A step renders ``batch_scenes`` scenes and gives each net one batch of
    3 positive and 3 negative crops a scene at its input size (12/24/48
    px; O-net's first, then P's and R's, drawn in ``crfr``'s order). Returns
    the last step's loss of each net."""
    rng = np.random.default_rng(seed)
    nets = {"p": mtcnn.pnet, "r": mtcnn.rnet, "o": mtcnn.onet}
    sizes = {"p": 12, "r": 24, "o": 48}
    steps_fn = {k: make_step(net, lr, with_lmk=k == "o") for k, net in nets.items()}
    losses = {k: torch.tensor(float("nan")) for k in nets}
    for _ in range(steps):
        scenes = [render_scene(rng, scene_size) for _ in range(batch_scenes)]
        batches = {k: [] for k in nets}
        for sc in scenes:
            base = sample_crops(rng, sc, sizes["o"], 3, 3, mtcnn.device)
            for k in nets:
                batches[k].append(base if k == "o" else
                                  sample_crops(rng, sc, sizes[k], 3, 3, mtcnn.device))
        for k in nets:
            xs = torch.cat([b[0] for b in batches[k]])
            cl, rg, lm = (np.concatenate([b[i] for b in batches[k]]) for i in (1, 2, 3))
            losses[k] = steps_fn[k](xs, cl, rg, lm)
    mtcnn.eval()
    return {f"{k}_loss": float(v) for k, v in losses.items()}
