"""Tile quantization and render-order scheduling (datatypes/tile.c parity).

In the reference, tiles are the unit of work handed to pthreads through a
mutex-guarded counter (tile.c:22-45). In the wavefront renderer the tile
list instead defines the PIXEL ORDER of the frame: tiles are packed into
fixed-size ray batches, so scheduling is a static permutation — no queue,
no mutex — but the user-visible semantics (tile sizes, the five orderings,
per-tile progress) are identical.

Orderings (tile.c:119-224): normal (scan order), topToBottom (reversed
build order), fromMiddle, toMiddle, random (Fisher-Yates-ish swap walk with
a rejection-sampled PCG32 seeded 3141592 — reproduced bit-exactly).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1
_PCG_MUL = 6364136223846793005


class _HostPCG32:
    """pcg32 (libraries/pcg_basic.c) in host Python ints."""

    def __init__(self, seed: int, seq: int = 0):
        self.inc = ((seq << 1) | 1) & M64
        self.state = 0
        self.next()
        self.state = (self.state + seed) & M64
        self.next()

    def next(self) -> int:
        old = self.state
        self.state = (old * _PCG_MUL + self.inc) & M64
        xorshifted = (((old >> 18) ^ old) >> 27) & M32
        rot = old >> 59
        return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & M32


def _rand_interval(lo: int, hi: int, rng: _HostPCG32) -> int:
    """Unbiased integer in [lo, hi] by bucket rejection (tile.c:132-146)."""
    rng_range = 1 + hi - lo
    buckets = M32 // rng_range  # UINT32_MAX / range
    limit = buckets * rng_range
    while True:
        r = rng.next()
        if r < limit:
            return lo + r // buckets


@dataclass
class RenderTile:
    """struct renderTile (tile.h:28-37)."""
    begin_x: int
    begin_y: int
    end_x: int
    end_y: int
    width: int
    height: int
    tile_num: int


def quantize_image(width: int, height: int, tile_w: int, tile_h: int,
                   order: str = "normal") -> list[RenderTile]:
    """quantizeImage (tile.c:66-117) + reorderTiles (tile.c:209-224)."""
    tile_w = min(max(tile_w, 1), width)
    tile_h = min(max(tile_h, 1), height)
    tiles_x = width // tile_w + (1 if width % tile_w else 0)
    tiles_y = height // tile_h + (1 if height % tile_h else 0)
    tiles = []
    num = 0
    for y in range(tiles_y):
        for x in range(tiles_x):
            ex = min((x + 1) * tile_w, width)
            ey = min((y + 1) * tile_h, height)
            bx, by = x * tile_w, y * tile_h
            tiles.append(RenderTile(bx, by, ex, ey, ex - bx, ey - by, num))
            num += 1
    return reorder_tiles(tiles, order)


def reorder_tiles(tiles: list[RenderTile], order: str) -> list[RenderTile]:
    n = len(tiles)
    if n == 0 or order == "normal":
        return tiles
    if order == "topToBottom":
        return tiles[::-1]
    if order == "fromMiddle":
        out = []
        mid_right = n // 2  # C integer division inside ceil() (tile.c:165)
        mid_left = mid_right - 1
        is_right = True
        for _ in range(n):
            if is_right:
                out.append(tiles[mid_right])
                mid_right += 1
            else:
                out.append(tiles[mid_left])
                mid_left -= 1
            is_right = not is_right
        return out
    if order == "toMiddle":
        out = []
        left, right = 0, n - 1
        is_right = True
        for _ in range(n):
            if is_right:
                out.append(tiles[right])
                right -= 1
            else:
                out.append(tiles[left])
                left += 1
            is_right = not is_right
        return out
    if order == "random":
        tiles = list(tiles)
        rng = _HostPCG32(3141592, 0)
        for i in range(n):
            j = _rand_interval(0, n - 1, rng)
            tiles[i], tiles[j] = tiles[j], tiles[i]
        return tiles
    return tiles  # unknown order string: scan order, like the C default


def pixel_order(width: int, height: int, tile_w: int, tile_h: int,
                order: str = "normal"):
    """Flat pixel index permutation: tiles in schedule order, row-major
    within each tile (the renderThread x/y loop, renderer.c:277-278).

    Returns (xs, ys, tiles, tile_offsets): int32 arrays of length W*H and
    the tile list; tile k covers [tile_offsets[k], tile_offsets[k+1]).
    """
    tiles = quantize_image(width, height, tile_w, tile_h, order)
    xs = np.empty(width * height, np.int32)
    ys = np.empty(width * height, np.int32)
    offsets = np.empty(len(tiles) + 1, np.int64)
    pos = 0
    for k, t in enumerate(tiles):
        offsets[k] = pos
        n = t.width * t.height
        gy, gx = np.mgrid[t.begin_y:t.end_y, t.begin_x:t.end_x]
        xs[pos:pos + n] = gx.reshape(-1)
        ys[pos:pos + n] = gy.reshape(-1)
        pos += n
    offsets[len(tiles)] = pos
    return xs, ys, tiles, offsets
