"""PNG writer with tEXt metadata (replaces utils/encoders/formats/png.c),
and the matching reader for 8-bit RGB PNGs. Standard library only: the
machine with the card has no PIL.

Embeds the same metadata keys the reference writes (png.c:37-60): Software,
CRay version, Image rendertime, Samples per pixel, Bounces, Renderer threads,
plus system info. The float framebuffer is y-up (row 0 = bottom), so rows
flip on write like the reference's texture storage.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from craytpu_torch.version import __version__, REFERENCE_VERSION


def _to_srgb_u8(fb: np.ndarray) -> np.ndarray:
    c = np.clip(fb[..., :3], 0.0, None).astype(np.float32)
    srgb = np.where(c <= 0.0031308, 12.92 * c,
                    1.055 * np.power(np.maximum(c, 1e-12), 1.0 / 2.4) - 0.055)
    return (np.minimum(srgb * 255.0, 255.0)).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray, metadata: dict | None = None) -> bytes:
    """(H, W, 3) uint8 rows, top first -> PNG bytes: colour type 2,
    8 bits, filter 0 on every row, one zlib stream, tEXt chunks for
    the metadata. Standard library only (no PIL)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    for k, v in (metadata or {}).items():
        out.append(_chunk(b"tEXt", str(k).encode("latin-1", "replace")
                          + b"\x00" + str(v).encode("latin-1", "replace")))
    out.append(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def write_png(path: str, framebuffer: np.ndarray, metadata: dict | None = None,
              already_srgb_u8: bool = False) -> None:
    fb = np.asarray(framebuffer)
    data = fb if already_srgb_u8 else _to_srgb_u8(fb)
    data = data[::-1]  # y-up buffer -> PNG top-down rows

    meta = {"Software": f"craytpu_torch {__version__} "
                        f"(c-ray {REFERENCE_VERSION} capabilities)"}
    meta.update(metadata or {})
    with open(path, "wb") as f:
        f.write(encode_png(data, meta))


def read_png_rgb(path: str) -> np.ndarray:
    """Decode an 8-bit RGB (colour type 2), non-interlaced PNG into
    (H, W, 3) uint8 rows, top first. Undoes filter types 0-4. Standard
    library only; raises ValueError on any other PNG form."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNGs are "
                         f"read (depth={depth} type={ctype} "
                         f"interlace={interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    bpp, stride = 3, 3 * w
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ft == 0:
            cur = line
        elif ft == 2:
            cur = (line + prev) & 0xFF
        else:
            # Sub, Average and Paeth depend on the already-decoded left
            # neighbour, so these rows decode pixel by pixel
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) >> 1
                elif ft == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                else:
                    raise ValueError(f"{path}: bad filter type {ft}")
                cur[i] = (line[i] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.reshape(h, w, 3).astype(np.uint8)


def write_bmp(path: str, framebuffer: np.ndarray) -> None:
    """Hand-rolled BMP (utils/encoders/formats/bmp.c:19-88): 24-bit BGR,
    bottom-up rows, row padding to 4 bytes."""

    data = _to_srgb_u8(np.asarray(framebuffer))
    h, w, _ = data.shape
    bgr = data[..., ::-1]  # already bottom-up since buffer is y-up
    row_bytes = w * 3
    pad = (4 - row_bytes % 4) % 4
    img_size = (row_bytes + pad) * h
    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", 54 + img_size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, img_size,
                            2835, 2835, 0, 0))
        padding = b"\x00" * pad
        for y in range(h):
            f.write(bgr[y].tobytes())
            f.write(padding)
