"""Packed record IO for identity-labeled face datasets (crfr/data/records.py).

Each record is a self-describing binary blob, the same bytes ``crfr`` writes:

    [u32 label][u16 fmt_len][fmt bytes: 'jpeg'|'png'|'raw'][u32 h][u32 w]
    [u32 c][payload bytes]

'raw' payload is uint8 HWC pixels (already aligned, the common case);
'jpeg'/'png' payloads are decoded with PIL, and raise a clear error where
PIL is not installed. The ``.crfrpack`` container (blobs, each behind its
u64 length, then a u64 offset index and a (count, index offset) footer) is
read and written here. ArrayRecord files need the ``array_record`` package,
which the port does not use: opening one raises, naming it.

``pack_aligned_list`` packs a landmarked list into aligned records: each
image decoded with PIL, aligned on the device (``ops.warp.align_faces``),
written by ``write_pack`` (``crfr``'s default writer is ArrayRecord's).
"""

from __future__ import annotations

import io
import os
import struct
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from crfr_torch.device import resolve_device
from crfr_torch.ops.warp import align_faces

_HDR = struct.Struct("<IH")
_DIMS = struct.Struct("<III")


def encode_record(label: int, image: np.ndarray | bytes, fmt: str = "raw") -> bytes:
    if isinstance(image, np.ndarray):
        if fmt != "raw" or image.dtype != np.uint8 or image.ndim != 3:
            raise ValueError("an array record is 'raw' uint8 HWC pixels")
        h, w, c = image.shape
        payload = image.tobytes()
    else:
        payload = image
        h = w = c = 0
    fmt_b = fmt.encode()
    return _HDR.pack(label, len(fmt_b)) + fmt_b + _DIMS.pack(h, w, c) + payload


def decode_record(blob: bytes) -> tuple[int, np.ndarray]:
    label, fmt_len = _HDR.unpack_from(blob, 0)
    off = _HDR.size
    fmt = blob[off:off + fmt_len].decode()
    off += fmt_len
    h, w, c = _DIMS.unpack_from(blob, off)
    off += _DIMS.size
    payload = blob[off:]
    if fmt == "raw":
        return label, np.frombuffer(payload, np.uint8).reshape(h, w, c)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"a {fmt!r} record needs PIL (the pillow package) to decode; "
                          "pack raw pixels to train without it") from e
    return label, np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))


def write_pack(path: str, records: Iterable[tuple[int, np.ndarray | bytes]],
               fmt: str = "raw") -> int:
    """Write (label, image) pairs as a ``.crfrpack``; returns the count."""
    offsets: list[int] = []
    with open(path, "wb") as f:
        for label, img in records:
            offsets.append(f.tell())
            blob = encode_record(int(label), img, fmt)
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
        footer_off = f.tell()
        for o in offsets:
            f.write(struct.pack("<Q", o))
        f.write(struct.pack("<QQ", len(offsets), footer_off))
    return len(offsets)


class PackSource:
    """Random-access reader of a ``.crfrpack``: source[i] → (label, image).
    Reads are positional (``os.pread``), so threads share one descriptor;
    it is reopened lazily in another process, so the source pickles."""

    def __init__(self, path: str):
        self._path = os.path.abspath(path)
        self._fd = -1
        self._pid = -1
        fd = self._get_fd()
        end = os.lseek(fd, 0, os.SEEK_END)
        n, footer_off = struct.unpack("<QQ", os.pread(fd, 16, end - 16))
        self._offsets = struct.unpack(f"<{n}Q", os.pread(fd, 8 * n, footer_off))

    def _get_fd(self) -> int:
        if self._fd < 0 or self._pid != os.getpid():
            self._fd = os.open(self._path, os.O_RDONLY)
            self._pid = os.getpid()
        return self._fd

    def __getstate__(self):
        return {"_path": self._path, "_offsets": self._offsets}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._fd = -1
        self._pid = -1

    def __len__(self) -> int:
        return len(self._offsets)

    def __getitem__(self, i: int) -> tuple[int, np.ndarray]:
        fd = self._get_fd()
        off = self._offsets[i]
        (ln,) = struct.unpack("<Q", os.pread(fd, 8, off))
        return decode_record(os.pread(fd, ln, off + 8))

    def __del__(self, _close=os.close):
        try:
            if self._fd >= 0 and self._pid == os.getpid():
                _close(self._fd)
        except (OSError, AttributeError, TypeError):
            pass


class SubsetSource:
    """View of a random-access source restricted to [start, stop)."""

    def __init__(self, source, start: int, stop: int):
        if not 0 <= start <= stop <= len(source):
            raise ValueError(f"subset [{start}, {stop}) of a source of {len(source)}")
        self._source = source
        self._start = start
        self._stop = stop

    def __len__(self) -> int:
        return self._stop - self._start

    def __getitem__(self, i: int):
        i = int(i)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self._source[self._start + i]


def open_source(path: str):
    """A random-access (label, image) source for ``path``: ``.crfrpack``
    (or any other name) is read here; ``.array_record`` and MXNet ``.rec``
    are not ported and raise."""
    if path.endswith((".array_record", ".arrayrecord")):
        raise NotImplementedError(
            f"{path}: ArrayRecord files need the array_record package, which crfr_torch "
            "does not use; convert to .crfrpack (crfr.data.records.write_pack)")
    if path.endswith(".rec"):
        raise NotImplementedError(f"{path}: MXNet .rec reading (crfr/data/mxrec.py) is not "
                                  "ported yet; convert to .crfrpack")
    return PackSource(path)


def pack_aligned_list(list_file: str, out_path: str, root: str = "", out_size: int = 112,
                      writer: Callable = write_pack,
                      device: str | torch.device = "cuda") -> int:
    """Pack a landmarked list into aligned records, one line a face:

        <path> <label> x1 y1 x2 y2 x3 y3 x4 y4 x5 y5

    (other lines are skipped). Each image is decoded with PIL, aligned on
    ``device`` by the 5-point solve and the warp, and rounded to uint8;
    ``writer(out_path, (label, image) records)`` writes them and returns the
    count."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("pack_aligned_list decodes images with PIL (the pillow package), "
                          "which is not installed") from e
    dev = resolve_device(device)

    def gen() -> Iterator[tuple[int, np.ndarray]]:
        with open(list_file) as f:
            for ln in f:
                parts = ln.split()
                if len(parts) != 12:
                    continue
                lm = np.asarray(parts[2:], np.float32).reshape(1, 5, 2)
                img = np.asarray(Image.open(os.path.join(root, parts[0])).convert("RGB"),
                                 np.uint8)
                yield int(parts[1]), align_faces(img, lm, out_size, device=dev)[0].cpu().numpy()

    return writer(out_path, gen())
