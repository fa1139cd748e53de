"""Image quantization and PNG I/O.

Quantization matches the reference writer exactly: clip to [0, 1], scale
by 255, truncate to uint8 (``astype`` truncates, it does not round).  PNG
files are written and read with the standard library's ``zlib`` (8-bit
RGB, no interlace), so the port needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(image: np.ndarray | torch.Tensor) -> np.ndarray:
    """(H, W, 3) float image -> uint8, reference-exact truncation."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image, dtype=np.float64)
    return (255.0 * np.clip(arr, 0.0, 1.0)).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def save_png(image: np.ndarray | torch.Tensor, path: str | Path) -> None:
    """Quantize with :func:`to_uint8` and write an 8-bit RGB PNG."""
    rgb = to_uint8(image)
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)  # filter 0
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    Path(path).write_bytes(
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def load_png(path: str | Path) -> np.ndarray:
    """uint8 (H, W, 3) array from an 8-bit RGB or RGBA, non-interlaced PNG."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are supported")
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (1, 3, 4):  # filters that read the pixel to the left
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                c = prev[x - channels] if x >= channels else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + prev[x]) // 2
                else:
                    pred = int(_paeth(np.int32(a), prev[x], np.int32(c)))
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: bad PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, channels)[..., :3].astype(np.uint8)
