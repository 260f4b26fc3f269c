"""Animated GIF on numpy alone: a fixed 256-colour palette, LZW coding.

The video writer for machines without imageio or cv2
(``utils/viz.py::frames_to_video``). ``quantize`` maps uint8 RGB to the
nearest palette entry: the 6x6x6 colour cube (levels 0, 51, ..., 255,
index 36 r + 6 g + b) and 40 more greys, so that the grey levels
round(k * 255 / 45), k = 0..45, are all in the palette (a depth map stays
smooth). ``write_gif`` codes each frame with GIF's variable-width LZW
(8-bit roots, codes up to 12 bits, a clear code when the table is full);
``read_gif`` decodes what it writes, for checks on machines without an
image library.
"""
from __future__ import annotations

import struct

import numpy as np

_CUBE = np.arange(6) * 51
_GREY_LEVELS = np.rint(np.arange(46) * 255.0 / 45.0).astype(np.int64)


def _palette():
    cube = np.stack(np.meshgrid(_CUBE, _CUBE, _CUBE, indexing="ij"),
                    -1).reshape(-1, 3)
    extra = [v for k, v in enumerate(_GREY_LEVELS) if k % 9]
    greys = np.repeat(np.asarray(extra)[:, None], 3, 1)
    return np.concatenate([cube, greys]).astype(np.uint8)


PALETTE = _palette()                     # [256, 3] uint8
# palette index of grey level k: the cube's grey where it has one
_GREY_INDEX = np.array([43 * (k // 9) if k % 9 == 0 else 216 + k - k // 9 - 1
                        for k in range(46)])


def quantize(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 -> [...] uint8 palette indices of the nearest entry
    (Euclidean; the cube's where a cube entry and a grey tie)."""
    x = np.asarray(rgb, np.int64)
    c = np.rint(x / 51.0).astype(np.int64)          # nearest cube level
    cube_idx = 36 * c[..., 0] + 6 * c[..., 1] + c[..., 2]
    d_cube = ((x - 51 * c) ** 2).sum(-1)
    # the nearest grey to x is the level nearest to x's mean
    k = np.clip(np.rint(x.sum(-1) / 3.0 * 45.0 / 255.0), 0, 45).astype(
        np.int64)
    best = np.stack([k - 1, k, k + 1], -1).clip(0, 45)
    d = ((x[..., None, :] - _GREY_LEVELS[best][..., None]) ** 2).sum(-1)
    kk = np.take_along_axis(best, d.argmin(-1)[..., None], -1)[..., 0]
    d_grey = d.min(-1)
    return np.where(d_cube <= d_grey, cube_idx, _GREY_INDEX[kk]).astype(
        np.uint8)


def _lzw_codes(data: bytes):
    """GIF LZW of 8-bit symbols -> (codes, widths): a clear code first and
    whenever the 4096-entry table fills, then the end code. Each code's
    width is what a decoder reads it with: 9 bits after a clear, one more
    once the decoder's table (which trails the coder's by one entry)
    reaches 512, 1024, 2048."""
    clear, end = 256, 257
    codes, widths = [clear], [9]
    table: dict = {}
    nxt, pos = 258, 0            # next free code; codes since the clear

    def put(code):
        nonlocal pos
        pos += 1
        codes.append(code)
        widths.append(min(12, (258 + max(pos - 2, 0)).bit_length()))

    prefix = data[0]
    for c in data[1:]:
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        put(prefix)
        table[key] = nxt
        nxt += 1
        if nxt == 4096:
            put(clear)
            table.clear()
            nxt, pos = 258, 0
        prefix = c
    put(prefix)
    put(end)
    return codes, widths


def _pack(codes, widths) -> bytes:
    """Codes of the given widths into bytes, least significant bit first."""
    codes = np.asarray(codes, np.int64)
    widths = np.asarray(widths, np.int64)
    start = np.cumsum(widths) - widths
    total = int(widths.sum())
    owner = np.repeat(np.arange(codes.size), widths)
    bit = np.arange(total) - start[owner]
    bits = ((codes[owner] >> bit) & 1).astype(np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


def _blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def write_gif(path: str, frames, fps: float = 30) -> None:
    """Write [H, W, 3] uint8 frames (all one size) as a looping GIF."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    h, w = frames[0].shape[:2]
    delay = max(1, int(round(100.0 / fps)))
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)   # global table of 256
    out += PALETTE.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop forever
    for f in frames:
        if f.shape[:2] != (h, w):
            raise ValueError(f"frame of {f.shape[:2]}, the first is {(h, w)}")
        out += struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0, delay, 0, 0)
        out += struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0)
        out.append(8)                                 # LZW minimum code size
        out += _blocks(_pack(*_lzw_codes(quantize(f).tobytes())))
    out.append(0x3B)
    with open(path, "wb") as fh:
        fh.write(bytes(out))


def _lzw_decode(data: bytes, min_size: int, n: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    clear, end = 1 << min_size, (1 << min_size) + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    out = bytearray()
    size, p, prev = min_size + 1, 0, None
    weights = 1 << np.arange(12)
    while p + size <= bits.size:
        code = int(bits[p:p + size] @ weights[:size])
        p += size
        if code == clear:
            del table[end + 1:]
            size, prev = min_size + 1, None
            continue
        if code == end:
            break
        if prev is None:
            entry = table[code]
        else:
            entry = (table[code] if code < len(table)
                     else table[prev] + table[prev][:1])
            if len(table) < 4096:
                table.append(table[prev] + entry[:1])
                if len(table) == 1 << size and size < 12:
                    size += 1
        out += entry
        prev = code
    return np.frombuffer(bytes(out[:n]), np.uint8)


def read_gif(path: str):
    """(palette [256, 3] uint8, frames [T, H, W] uint8 palette indices) of
    a GIF with a global colour table and full-size frames, as write_gif
    writes."""
    with open(path, "rb") as fh:
        b = fh.read()
    if b[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF")
    w, h, packed = struct.unpack("<HHB", b[6:11])
    n_pal = 2 << (packed & 7)
    palette = np.frombuffer(b[13:13 + 3 * n_pal], np.uint8).reshape(-1, 3)
    p, frames = 13 + 3 * n_pal, []
    while p < len(b):
        tag = b[p]
        if tag == 0x3B:
            break
        if tag == 0x21:                               # extension
            p += 2
            while b[p]:
                p += b[p] + 1
            p += 1
            continue
        if tag != 0x2C:
            raise ValueError(f"{path}: unexpected block {tag:#x}")
        fw, fh_ = struct.unpack("<HH", b[p + 5:p + 9])
        p += 10
        min_size = b[p]
        p += 1
        data = bytearray()
        while b[p]:
            data += b[p + 1:p + 1 + b[p]]
            p += b[p] + 1
        p += 1
        frames.append(_lzw_decode(bytes(data), min_size, fw * fh_)
                      .reshape(fh_, fw))
    return palette, np.stack(frames)
