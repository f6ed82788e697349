"""Radiance RGBE (.hdr) decoder, numpy implementation.

Replaces the reference's stbi_loadf HDR path (textureloader.c:39-55).
Produces float32 (H, W, 3) with the same RGBE->float conversion stb_image
uses: f = ldexp(c, e - 136) per 8-bit mantissa channel.
"""

from __future__ import annotations

import numpy as np


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.ldexp(np.float32(1.0), e - (128 + 8)).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[e == 0] = 0.0
    return out


def read_hdr(path: str) -> np.ndarray:
    from craytpu_torch.utils.fileio import load_file
    data = load_file(path)

    # header
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported HDR orientation {res}")
    height = int(res[1])
    width = int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    img = np.zeros((height, width, 4), np.uint8)
    p = 0
    for y in range(height):
        if width < 8 or width > 0x7FFF or buf[p] != 2 or buf[p + 1] != 2 \
                or (buf[p + 2] & 0x80):
            # flat (non-RLE) scanline(s): rest of file is raw RGBE
            remaining = buf[p:]
            flat = remaining[: (height - y) * width * 4].reshape(
                height - y, width, 4)
            img[y:] = flat
            break
        # adaptive RLE scanline
        scan_w = (int(buf[p + 2]) << 8) | int(buf[p + 3])
        if scan_w != width:
            raise ValueError(f"{path}: bad scanline width")
        p += 4
        for c in range(4):
            x = 0
            while x < width:
                cnt = int(buf[p])
                p += 1
                if cnt > 128:  # run
                    img[y, x:x + cnt - 128, c] = buf[p]
                    p += 1
                    x += cnt - 128
                else:  # literal
                    img[y, x:x + cnt, c] = buf[p:p + cnt]
                    p += cnt
                    x += cnt
    return _decode_rgbe(img)
