"""MXNet RecordIO (``.rec``/``.idx``) reader and writer (crfr/data/mxrec.py),
for insightface's packed training sets (``train.rec``).

The layout (MXNet's public recordio format):

  record := [u32 magic=0xced7230a][u32 lrec][data (len bytes)][pad to 4 B]
            cflag = lrec >> 29, len = lrec & 0x1fffffff
            (cflag 0: a whole record; 1/2/3: the first, a middle and the
            last part of a record split in parts, joined in order)
  .idx    := text lines "<int key>\\t<byte offset>"

An image record starts with an IRHeader (struct '<IfQQ': flag, label, id,
id2). With flag > 0 the label field is replaced by ``flag`` f32 labels after
the header; the image bytes follow them.

insightface's identity packs add a meta record at key 0 whose two labels
[ident_start, ident_end) delimit per-identity records at the end of the
file; image records are keys 1 ... ident_start − 1, each with its identity
as its first label. ``MXFaceSource`` detects this and exposes only the
image records. Training reads ``.crfrpack`` (``data.records``):
``convert_rec`` (``python -m crfr_torch pack --from-rec``) converts.

Reads are positional (``os.pread``) on a descriptor reopened lazily in
another process, as ``records.PackSource`` reads. Images decode with PIL
(the pillow package), which raises an error naming it where it is missing.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Callable, Iterable, Iterator

import numpy as np

_MAGIC = 0xCED7230A
_LEN_MASK = (1 << 29) - 1
_U32x2 = struct.Struct("<II")
_IRHEADER = struct.Struct("<IfQQ")          # flag, label, id, id2


def pack_irheader(label, img_bytes: bytes, rec_id: int = 0) -> bytes:
    """An image record's payload: the IRHeader, the labels when there is more
    than one, then ``img_bytes``. ``label``: a float or a 1-D sequence."""
    labels = np.atleast_1d(np.asarray(label, np.float32))
    if labels.size == 1:
        return _IRHEADER.pack(0, float(labels[0]), rec_id, 0) + img_bytes
    return _IRHEADER.pack(labels.size, 0.0, rec_id, 0) + labels.tobytes() + img_bytes


def unpack_irheader(data: bytes) -> tuple[np.ndarray, bytes]:
    """→ (labels (k,) f32, payload bytes)."""
    flag, label, _id, _id2 = _IRHEADER.unpack_from(data, 0)
    off = _IRHEADER.size
    if flag > 0:
        labels = np.frombuffer(data, np.float32, count=flag, offset=off)
        off += 4 * flag
    else:
        labels = np.asarray([label], np.float32)
    return labels, data[off:]


class MXIndexedRecordIO:
    """An indexed ``.rec``: ``read_idx(key)`` → the record's payload bytes."""

    def __init__(self, rec_path: str, idx_path: str | None = None):
        self._path = os.path.abspath(rec_path)
        if idx_path is None:
            idx_path = os.path.splitext(rec_path)[0] + ".idx"
        self._offsets: dict[int, int] = {}
        with open(idx_path) as f:
            for ln in f:
                parts = ln.split()
                if len(parts) >= 2:
                    self._offsets[int(parts[0])] = int(parts[1])
        self._fd = -1
        self._pid = -1

    def _get_fd(self) -> int:
        if self._fd < 0 or self._pid != os.getpid():
            self._fd = os.open(self._path, os.O_RDONLY)
            self._pid = os.getpid()
        return self._fd

    def __getstate__(self):
        return {**self.__dict__, "_fd": -1, "_pid": -1}

    def __del__(self, _close=os.close):
        try:
            if self._fd >= 0 and self._pid == os.getpid():
                _close(self._fd)
        except (OSError, AttributeError, TypeError):
            pass

    @property
    def keys(self) -> list[int]:
        return sorted(self._offsets)

    def read_at(self, offset: int) -> bytes:
        """The record (all its parts, joined) that starts at ``offset``."""
        fd = self._get_fd()
        parts = []
        while True:
            magic, lrec = _U32x2.unpack(os.pread(fd, 8, offset))
            if magic != _MAGIC:
                raise ValueError(f"bad recordio magic {magic:#x} @ {offset}")
            cflag = lrec >> 29
            length = lrec & _LEN_MASK
            parts.append(os.pread(fd, length, offset + 8))
            offset += 8 + ((length + 3) & ~3)        # padded to 4 bytes
            if cflag in (0, 3):                       # whole, or the last part
                break
        return b"".join(parts)

    def read_idx(self, key: int) -> bytes:
        return self.read_at(self._offsets[key])


def _decode_image(payload: bytes) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("a .rec image record is encoded: decoding it needs PIL (the "
                          "pillow package), which is not installed") from e
    return np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"), np.uint8)


class MXFaceSource:
    """Random-access (label, image) source over an insightface-style ``.rec``
    (``len`` and ``[i]``, as ``records.PackSource``). With insightface's
    meta record (key 0 with two labels) only the image records are exposed;
    a plain im2rec file exposes every key."""

    def __init__(self, rec_path: str, idx_path: str | None = None):
        self._rec = MXIndexedRecordIO(rec_path, idx_path)
        keys = self._rec.keys
        self._keys = keys
        if keys and keys[0] == 0:
            labels, payload = unpack_irheader(self._rec.read_idx(0))
            if len(payload) == 0 and labels.size >= 2:
                ident_start = int(labels[0])
                self._keys = [k for k in keys if 1 <= k < ident_start]

    def __len__(self) -> int:
        return len(self._keys)

    def __getitem__(self, i: int) -> tuple[int, np.ndarray]:
        labels, payload = unpack_irheader(self._rec.read_idx(self._keys[int(i)]))
        return int(labels[0]), _decode_image(payload)


def write_mx_record(rec_path: str, records: Iterable[tuple[float, bytes]],
                    idx_path: str | None = None, insightface_meta: bool = False) -> int:
    """Write a ``.rec``/``.idx`` pair of (label, encoded image bytes); with
    ``insightface_meta`` the key-0 meta record comes first, as in MS1M's
    ``train.rec``. Returns the number of image records."""
    if idx_path is None:
        idx_path = os.path.splitext(rec_path)[0] + ".idx"
    recs = list(records)
    if insightface_meta:
        n = len(recs)
        entries = [(0, pack_irheader([float(n + 1), float(n + 1)], b""))]
        entries += [(i + 1, pack_irheader(lb, img)) for i, (lb, img) in enumerate(recs)]
    else:
        entries = [(i, pack_irheader(lb, img)) for i, (lb, img) in enumerate(recs)]
    with open(rec_path, "wb") as f, open(idx_path, "w") as fi:
        for key, data in entries:
            fi.write(f"{key}\t{f.tell()}\n")
            f.write(_U32x2.pack(_MAGIC, len(data)))   # cflag 0
            f.write(data)
            f.write(b"\x00" * (-len(data) % 4))
    return len(recs)


def convert_rec(rec_path: str, out_path: str, idx_path: str | None = None,
                writer: Callable | None = None) -> tuple[int, int]:
    """A ``.rec`` → records of raw pixels, each image decoded once, written by
    ``writer`` (``records.write_pack`` when None). Returns (images,
    identities); the labels are taken as they are (insightface's are
    dense)."""
    from crfr_torch.data.records import write_pack

    writer = write_pack if writer is None else writer
    src = MXFaceSource(rec_path, idx_path)
    seen: set[int] = set()

    def gen() -> Iterator[tuple[int, np.ndarray]]:
        for i in range(len(src)):
            label, img = src[i]
            seen.add(label)
            yield label, img

    n = writer(out_path, gen())
    return n, len(seen)
