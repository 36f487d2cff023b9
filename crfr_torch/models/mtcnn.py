"""MTCNN face detector: the P/R/O-net cascade (crfr/models/mtcnn.py).

The three nets are float32 modules with the canonical MTCNN widths. They
take NHWC normalized pixels, as ``crfr``'s do, and run NCHW convolutions on
a ``channels_last`` view of them; ``PNet`` hands back its regression map
in ``crfr``'s NHWC layout, and R/O-net flatten an NHWC view (H·W·C order)
before their first linear layer, as ``crfr`` flattens.

``MTCNN.detect`` moves the photo to the device once, uint8 when it is
uint8 (the same sums as ``crfr``'s float32 path on integer values), and
builds every pyramid level with one launch of the resize kernel's pyramid
form (``fused_pyramid_normalize``: each level PIL bicubic from the photo,
then (x − 127.5)/128, float32 out), where ``crfr`` resizes on the host. All
the crops of the R-net stage, and then of the O-net stage, come from one
launch of its crop form each (``crop_resize``: ``fused_crop_resize_normalize``
cuts each box from the photo on the device, reads zeros where it leaves the
photo, and resizes it), so a ``detect`` launches the kernel three times.
The irregular parts (box decode, NMS, pyramid bookkeeping, ``np.round``'s
half-to-even and the ``astype(int)`` truncation of the crop boxes) stay
numpy on the host, copied from ``crfr``. ``crfr`` pads the R/O-net batches
to a power of two for XLA's static shapes; the nets have no batch
statistics, so the port runs each batch as it is.

No pretrained weights exist offline: the nets start from weights drawn from
``seed`` (``train.mtcnn_train`` trains them on rendered faces), and
``load_torch_weights`` imports a standard torch MTCNN state_dict in order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from crfr_torch.device import resolve_device
from crfr_torch.models.irse import PReLU, init_weights
from crfr_torch.ops.fused_preprocess import fused_crop_resize_normalize, fused_pyramid_normalize


class _MaxPool(nn.Module):
    """Max-pool in ceil mode: a window that overhangs the bottom or right
    edge takes the maximum of what it covers, as ``crfr``'s −inf padding."""

    def __init__(self, size: int, stride: int):
        super().__init__()
        self.size, self.stride = size, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.size, self.stride, ceil_mode=True)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC pixels → an NCHW view in ``channels_last`` memory (no copy)."""
    return x.permute(0, 3, 1, 2)


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    """Fully convolutional proposal net; stride 2, receptive field 12.
    (B, H, W, 3) → prob (B, h, w), reg (B, h, w, 4)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = PReLU(10)
        self.pool = _MaxPool(2, 2)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = PReLU(32)
        self.cls = nn.Conv2d(32, 2, 1)
        self.reg = nn.Conv2d(32, 4, 1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.pool(self.prelu1(self.conv1(_nchw(x))))
        x = self.prelu3(self.conv3(self.prelu2(self.conv2(x))))
        prob = torch.softmax(self.cls(x), dim=1)[:, 1]
        return prob, self.reg(x).permute(0, 2, 3, 1)


class RNet(nn.Module):
    """Refinement net on 24×24 crops → prob (B,), reg (B, 4)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = PReLU(28)
        self.pool1 = _MaxPool(3, 2)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = PReLU(48)
        self.pool2 = _MaxPool(3, 2)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = PReLU(64)
        self.fc = nn.Linear(3 * 3 * 64, 128)
        self.prelu4 = PReLU(128)
        self.cls = nn.Linear(128, 2)
        self.reg = nn.Linear(128, 4)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.pool1(self.prelu1(self.conv1(_nchw(x))))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.prelu4(self.fc(_flatten_hwc(self.prelu3(self.conv3(x)))))
        return torch.softmax(self.cls(x), -1)[:, 1], self.reg(x)


class ONet(nn.Module):
    """Output net on 48×48 crops → prob (B,), reg (B, 4), landmarks (B, 10)
    as (x1..x5, y1..y5) relative to the box."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = PReLU(32)
        self.pool1 = _MaxPool(3, 2)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = PReLU(64)
        self.pool2 = _MaxPool(3, 2)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = PReLU(64)
        self.pool3 = _MaxPool(2, 2)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = PReLU(128)
        self.fc = nn.Linear(3 * 3 * 128, 256)
        self.prelu5 = PReLU(256)
        self.cls = nn.Linear(256, 2)
        self.reg = nn.Linear(256, 4)
        self.lmk = nn.Linear(256, 10)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.pool1(self.prelu1(self.conv1(_nchw(x))))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.pool3(self.prelu3(self.conv3(x)))
        x = self.prelu5(self.fc(_flatten_hwc(self.prelu4(self.conv4(x)))))
        return torch.softmax(self.cls(x), -1)[:, 1], self.reg(x), self.lmk(x)


# ---------------------------------------------------------------------------
# Host-side cascade machinery (numpy, as in crfr)
# ---------------------------------------------------------------------------


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float,
        method: str = "union") -> np.ndarray:
    """Greedy NMS; boxes (N, 4) [x1 y1 x2 y2]. Returns kept indices."""
    if len(boxes) == 0:
        return np.zeros(0, np.int64)
    x1, y1, x2, y2 = boxes.T
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(scores)[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = (np.maximum(0.0, xx2 - xx1 + 1)
                 * np.maximum(0.0, yy2 - yy1 + 1))
        if method == "min":
            o = inter / np.minimum(area[i], area[order[1:]])
        else:
            o = inter / (area[i] + area[order[1:]] - inter)
        order = order[1:][o <= thresh]
    return np.asarray(keep, np.int64)


def decode_pnet(prob: np.ndarray, reg: np.ndarray, scale: float,
                thresh: float) -> np.ndarray:
    """Dense PNet map (h, w), (h, w, 4) → candidate boxes (N, 9): x1 y1 x2
    y2 score reg4. Stride 2, cell size 12 (canonical MTCNN decode)."""
    stride, cell = 2, 12
    ys, xs = np.where(prob >= thresh)
    if len(ys) == 0:
        return np.zeros((0, 9), np.float32)
    scores = prob[ys, xs]
    regs = reg[ys, xs]
    x1 = np.round(stride * xs / scale)
    y1 = np.round(stride * ys / scale)
    x2 = np.round((stride * xs + cell) / scale)
    y2 = np.round((stride * ys + cell) / scale)
    return np.concatenate([
        np.stack([x1, y1, x2, y2, scores], 1), regs], 1).astype(np.float32)


def apply_regression(boxes: np.ndarray) -> np.ndarray:
    """Apply bbox regression deltas (cols 5:9) to boxes (cols 0:4)."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    out = boxes[:, :5].copy()
    out[:, 0] += boxes[:, 5] * w
    out[:, 1] += boxes[:, 6] * h
    out[:, 2] += boxes[:, 7] * w
    out[:, 3] += boxes[:, 8] * h
    return out


def square_boxes(boxes: np.ndarray) -> np.ndarray:
    out = boxes.copy()
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = np.maximum(w, h)
    out[:, 0] += w * 0.5 - side * 0.5
    out[:, 1] += h * 0.5 - side * 0.5
    out[:, 2] = out[:, 0] + side
    out[:, 3] = out[:, 1] + side
    return out


def crop_resize(img: torch.Tensor, boxes: np.ndarray, size: int) -> torch.Tensor:
    """Crop ``boxes`` (their ``astype(int)`` truncation, as ``crfr``) from
    ``img`` (H, W, C) uint8 or float32, zero-padded where a box leaves the
    image, and bicubic-resize each to size² with one launch of the crop form
    of the resize kernel: (N, size, size, C) float32 normalized pixels on
    ``img``'s device. A box with no area gives a crop of zeros before
    normalization, as in ``crfr``."""
    return fused_crop_resize_normalize(img, boxes[:, :4].astype(int), size, "pil",
                                       torch.float32)


def photo_tensor(img, device: torch.device) -> torch.Tensor:
    """A photo (H, W, C) on ``device``: uint8 when it is uint8, else float32."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclass
class Detection:
    boxes: np.ndarray          # (N, 4) x1 y1 x2 y2
    scores: np.ndarray         # (N,)
    landmarks: np.ndarray      # (N, 5, 2) absolute image coords


def _empty() -> Detection:
    return Detection(np.zeros((0, 4)), np.zeros(0), np.zeros((0, 5, 2)))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class MTCNN(nn.Module):
    """The full cascade on ``device`` (CUDA unless the caller asks for the
    CPU), nets drawn from ``seed``, ``seed + 1``, ``seed + 2``."""

    def __init__(self, min_face: int = 20, scale_factor: float = 0.709,
                 thresholds=(0.6, 0.7, 0.7), seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.min_face = min_face
        self.scale_factor = scale_factor
        self.thresholds = thresholds
        self.device = resolve_device(device)
        self.pnet = init_weights(PNet(), torch.Generator().manual_seed(seed))
        self.rnet = init_weights(RNet(), torch.Generator().manual_seed(seed + 1))
        self.onet = init_weights(ONet(), torch.Generator().manual_seed(seed + 2))
        self.to(self.device).eval()

    def _pyramid_scales(self, h: int, w: int) -> list[float]:
        scale = 12.0 / self.min_face
        minl = min(h, w) * scale
        scales = []
        while minl >= 12:
            scales.append(scale)
            scale *= self.scale_factor
            minl *= self.scale_factor
        return scales

    def pyramid_sizes(self, h: int, w: int) -> list[tuple[float, tuple[int, int]]]:
        """(scale, (height, width)) of each pyramid level of an (h, w) photo."""
        sizes = [(s, (int(np.ceil(h * s)), int(np.ceil(w * s))))
                 for s in self._pyramid_scales(h, w)]
        return [(s, hw) for s, hw in sizes if min(hw) >= 12]

    @torch.inference_mode()
    def pyramid(self, x: torch.Tensor) -> list[tuple[float, torch.Tensor, torch.Tensor]]:
        """Stage 1 on the device: (scale, prob, reg) of PNet at each level of
        the photo ``x`` (H, W, C); one launch of the pyramid form for every
        level."""
        sizes = self.pyramid_sizes(*x.shape[:2])
        levels = fused_pyramid_normalize(x[None], [hw for _, hw in sizes], "pil", torch.float32)
        out = []
        for (s, _), scaled in zip(sizes, levels):
            prob, reg = self.pnet(scaled)
            out.append((s, prob[0], reg[0]))
        return out

    def stage1(self, x: torch.Tensor) -> np.ndarray:
        """The candidate boxes (N, 9) of the pyramid after NMS and regression."""
        return self.candidates(self.pyramid(x))

    def candidates(self, levels: list) -> np.ndarray:
        """Stage 1 on the host: ``pyramid``'s maps → the candidate boxes."""
        cands = []
        for s, prob, reg in levels:
            b = decode_pnet(_host(prob), _host(reg), s, self.thresholds[0])
            if len(b):
                cands.append(b[nms(b[:, :4], b[:, 4], 0.5)])
        if not cands:
            return np.zeros((0, 9), np.float32)
        boxes = np.concatenate(cands)
        boxes = boxes[nms(boxes[:, :4], boxes[:, 4], 0.7)]
        return square_boxes(apply_regression(boxes))

    @torch.inference_mode()
    def stage2(self, x: torch.Tensor, boxes: np.ndarray) -> np.ndarray:
        prob, reg = (_host(t) for t in self.rnet(crop_resize(x, boxes, 24)))
        keep = prob >= self.thresholds[1]
        boxes = np.concatenate([boxes[keep, :4], prob[keep, None], reg[keep]], 1)
        if len(boxes) == 0:
            return boxes
        boxes = boxes[nms(boxes[:, :4], boxes[:, 4], 0.7)]
        return square_boxes(apply_regression(boxes))

    @torch.inference_mode()
    def stage3(self, x: torch.Tensor, boxes: np.ndarray) -> Detection:
        prob, reg, lmk = (_host(t) for t in self.onet(crop_resize(x, boxes, 48)))
        keep = prob >= self.thresholds[2]
        boxes4, prob, reg, lmk = boxes[keep, :4], prob[keep], reg[keep], lmk[keep]
        bw = boxes4[:, 2] - boxes4[:, 0]
        bh = boxes4[:, 3] - boxes4[:, 1]
        # landmarks: 10 = (x1..x5, y1..y5) relative to the box
        lx = boxes4[:, 0:1] + lmk[:, 0:5] * bw[:, None]
        ly = boxes4[:, 1:2] + lmk[:, 5:10] * bh[:, None]
        lms = np.stack([lx, ly], axis=-1)
        final = apply_regression(np.concatenate([boxes4, prob[:, None], reg], 1))
        keep2 = nms(final[:, :4], final[:, 4], 0.7, method="min")
        return Detection(final[keep2, :4], final[keep2, 4], lms[keep2])

    @torch.inference_mode()
    def detect(self, img) -> Detection:
        """img (H, W, 3) uint8/float RGB → Detection."""
        x = photo_tensor(img, self.device)
        boxes = self.stage1(x)
        if len(boxes) == 0:
            return _empty()
        boxes = self.stage2(x, boxes)
        if len(boxes) == 0:
            return _empty()
        return self.stage3(x, boxes)

    # -- torch weight import ------------------------------------------------
    def load_torch_weights(self, pnet_sd=None, rnet_sd=None, onet_sd=None) -> None:
        """Import standard torch MTCNN state_dicts (facenet-pytorch naming or
        any other): each dict's tensors are consumed in their order onto
        the net's parameters in definition order (conv weight and bias,
        linear weight and bias, PReLU weight), as ``crfr`` imports them."""
        for net, sd in ((self.pnet, pnet_sd), (self.rnet, rnet_sd), (self.onet, onet_sd)):
            if sd is not None:
                _load_by_order(net, sd)


def _load_by_order(net: nn.Module, sd) -> None:
    tensors = iter(torch.as_tensor(np.asarray(v.detach().cpu().numpy()
                                              if hasattr(v, "detach") else v))
                   for v in sd.values())
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                params = [mod.weight] + ([mod.bias] if mod.bias is not None else [])
            elif isinstance(mod, PReLU):
                params = [mod.weight]
            else:
                continue
            for p in params:
                t = next(tensors)
                if tuple(t.shape) != tuple(p.shape):
                    raise ValueError(f"{type(net).__name__}: a tensor of shape "
                                     f"{tuple(t.shape)} where {tuple(p.shape)} is next")
                p.copy_(t)
