"""PNG read and write on zlib and numpy.

The dataset loaders read images with cv2 or imageio where one of them is
installed, as the JAX package's loaders do; on a machine with neither
they read PNG files through this module, and ``vis_final`` writes its
views with it. What it covers: 8-bit gray, RGB and RGBA, 16-bit gray,
non-interlaced, all five filter types on read. Anything else raises
``ValueError`` naming the file.

``read_png`` returns what ``imageio.imread`` returns for those files: a
[H, W] array for gray (uint8 or uint16), [H, W, 3] or [H, W, 4] uint8
otherwise. ``write_png`` writes every row with filter 0 (none).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 gray, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    """Undo the per-row filters of the decompressed stream."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: image data too short")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:   # sub: a running sum per byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:   # up
            cur = line + prev
        elif ftype in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(
                buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = hdr
    if ctype not in _CHANNELS or interlace or comp or filt:
        raise ValueError(
            f"{path}: colour type {ctype}, interlace {interlace}: only "
            f"non-interlaced gray, RGB and RGBA are read")
    ch = _CHANNELS[ctype]
    if depth != 8 and not (depth == 16 and ctype == 0):
        raise ValueError(f"{path}: bit depth {depth} with colour type "
                         f"{ctype}: 8-bit or 16-bit gray only")
    bpp = ch * depth // 8
    img = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp,
                    bpp, path)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(height, width, ch)
    return img[..., 0] if ch == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """``img``: [H, W] uint8 or uint16, or [H, W, 3|4] uint8."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        ctype, depth = 0, 8 * img.dtype.itemsize
    elif img.ndim == 3 and img.shape[2] in (3, 4) and img.dtype == np.uint8:
        ctype, depth = (2 if img.shape[2] == 3 else 6), 8
    else:
        raise ValueError(f"{path}: cannot write {img.dtype} {img.shape}; "
                         f"[H, W] uint8/uint16 or [H, W, 3|4] uint8")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))
