"""A configuration, a traffic mix and a seed -> the scene buffer both
sides are handed and the pixels the check compares.

The configuration file holds the scene JSON as the repository ships it
(`scene`), and the directory of its OBJ/MTL files (`asset_dir`, relative
to the checkout) with each file's SHA-256 (`assets`). The traffic mix
sets the CLI's overrides (`cli`: `-d` width and height, `-s` samples),
as a user passes them on the command line. Every seed renders that scene
from the same pose: a change of camera pose moves the persistent pool's
discrete refill and drain steps, and with them the work of a frame by up
to 16% (PERF.md). The seed draws the first chunk of passes, the
checked pixels and the checked request.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream `stream` of the run's seed (any integer)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


# the seed's streams: the checked pixels, the checked request, the first
# chunk of passes
PIXELS, KEEP, CHUNK = 1, 2, 3


def check_assets(config: dict, root: str) -> str:
    """The absolute asset directory, after checking every file's hash."""
    adir = os.path.join(root, config["asset_dir"])
    for name, digest in config["assets"].items():
        with open(os.path.join(adir, name), "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != digest:
            raise RuntimeError(f"{config['asset_dir']}/{name} changed: sha256 "
                               f"{got}, the configuration states {digest}")
    return adir + os.sep


def scene(config: dict, traffic: dict) -> dict:
    """The scene as run: the configuration's, with the traffic's CLI
    overrides in its renderer block."""
    sc = copy.deepcopy(config["scene"])
    sc["renderer"].update(traffic.get("cli", {}))
    return sc


def scene_text(config: dict, traffic: dict) -> str:
    """The scene JSON both sides load."""
    return json.dumps(scene(config, traffic))


def check_pixels(sc: dict, n: int, seed: int) -> tuple:
    """The (xs, ys) of n distinct pixels of scene `sc`, drawn from the
    seed."""
    r = sc["renderer"]
    w, h = int(r["width"]), int(r["height"])
    idx = rng(seed, PIXELS).choice(w * h, size=n, replace=False)
    return (idx % w).astype(np.int64), (idx // w).astype(np.int64)
