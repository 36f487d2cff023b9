"""Dataset readers (crfr/data/datasets.py): identity folders, LFW pairs
lists, probe/gallery lists.

- identity folder tree: ``root/<identity>/<image>`` (labels in sorted
  folder order);
- LFW ``pairs.txt``: header "n_folds n_per_fold"; same pairs "name i j";
  different pairs "name1 i name2 j"; images at
  ``lfw_root/name/name_%04d.jpg``;
- generic pairs: ``path1 path2 issame`` per line;
- probe/gallery lists: ``path label`` per line; SCface splits from its
  file names ``<id>_frontal.jpg`` (gallery) and ``<id>_cam<k>_<d>.jpg``
  (probes at distance d); open-set splits from three list files.

Images decode with PIL (the pillow package); where it is not installed,
``load_image`` raises an error that names it.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

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


class FolderDataset:
    """An identity folder tree; ``ds[i]`` → (image uint8 HWC, label)."""

    def __init__(self, root: str, size: int | None = 112):
        self.root = root
        self.size = size
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: list[tuple[str, int]] = []
        for c in classes:
            d = os.path.join(root, c)
            for name in sorted(os.listdir(d)):
                if name.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    self.samples.append((os.path.join(d, name), self.class_to_idx[c]))

    @property
    def num_classes(self) -> int:
        return len(self.class_to_idx)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int):
        path, label = self.samples[i]
        return load_image(path, self.size), label


@dataclass
class PairsProtocol:
    path1: list[str]
    path2: list[str]
    issame: np.ndarray
    n_folds: int = 10


def parse_lfw_pairs(pairs_file: str, lfw_root: str, ext: str = ".jpg") -> PairsProtocol:
    """LFW's ``pairs.txt`` → explicit image paths, ``issame`` and the folds."""
    with open(pairs_file) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    header = lines[0].split()
    n_folds = int(header[0]) if header else 10
    p1, p2, same = [], [], []

    def img(name: str, idx: int) -> str:
        return os.path.join(lfw_root, name, f"{name}_{int(idx):04d}{ext}")

    for ln in lines[1:]:
        parts = ln.split()
        if len(parts) == 3:
            p1.append(img(parts[0], int(parts[1])))
            p2.append(img(parts[0], int(parts[2])))
            same.append(True)
        elif len(parts) == 4:
            p1.append(img(parts[0], int(parts[1])))
            p2.append(img(parts[2], int(parts[3])))
            same.append(False)
    return PairsProtocol(p1, p2, np.asarray(same), n_folds)


def parse_generic_pairs(pairs_file: str, root: str = "") -> PairsProtocol:
    """``path1 path2 issame`` per line (issame: 1/0/true/false); other lines
    are skipped."""
    p1, p2, same = [], [], []
    with open(pairs_file) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) != 3:
                continue
            p1.append(os.path.join(root, parts[0]))
            p2.append(os.path.join(root, parts[1]))
            same.append(parts[2].lower() in ("1", "true", "t", "yes"))
    return PairsProtocol(p1, p2, np.asarray(same))


@dataclass
class ProbeGallerySplit:
    gallery_paths: list[str]
    gallery_labels: np.ndarray
    probe_paths: list[str]
    probe_labels: np.ndarray
    probe_mated: np.ndarray | None = None     # open-set protocols only


_SCFACE_RE = re.compile(r"^(?P<id>\d+)_cam(?P<cam>\d)_(?P<dist>\d)\.")
_SCFACE_MUGSHOT_RE = re.compile(r"^(?P<id>\d+)_frontal\.")


def scface_split(gallery_dir: str, probe_dir: str, distance: int) -> ProbeGallerySplit:
    """SCface: the HR frontal mugshots (``<id>_frontal.*``) as the gallery,
    the surveillance shots at ``distance`` d ∈ {1, 2, 3}
    (``<id>_cam<k>_<d>.*``) as the probes, each in sorted name order."""
    g_paths, g_labels = [], []
    for name in sorted(os.listdir(gallery_dir)):
        m = _SCFACE_MUGSHOT_RE.match(name)
        if m:
            g_paths.append(os.path.join(gallery_dir, name))
            g_labels.append(int(m.group("id")))
    p_paths, p_labels = [], []
    for name in sorted(os.listdir(probe_dir)):
        m = _SCFACE_RE.match(name)
        if m and int(m.group("dist")) == distance:
            p_paths.append(os.path.join(probe_dir, name))
            p_labels.append(int(m.group("id")))
    return ProbeGallerySplit(g_paths, np.asarray(g_labels), p_paths, np.asarray(p_labels))


def open_set_split(gallery_list: str, mated_list: str, unmated_list: str,
                   root: str = "") -> ProbeGallerySplit:
    """A TinyFace / QMUL-SurvFace open-set split from three list files: the
    probes are the mated ones, then the unmated."""
    g_paths, g_labels = parse_list_file(gallery_list, root)
    m_paths, m_labels = parse_list_file(mated_list, root)
    u_paths, u_labels = parse_list_file(unmated_list, root)
    mated = np.concatenate([np.ones(len(m_paths), bool), np.zeros(len(u_paths), bool)])
    return ProbeGallerySplit(g_paths, g_labels, m_paths + u_paths,
                             np.concatenate([m_labels, u_labels]), probe_mated=mated)
