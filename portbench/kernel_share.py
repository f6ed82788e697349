"""A kernel's share of its byte bound in a traced window."""

from __future__ import annotations

import sys

from portbench import roofline
from portbench.profiling import KERNELS

BYTES = {"hitrec": roofline.k1_bytes, "closest_hit": roofline.k2_bytes}


def share(run, wrapper: str):
    """Per cent of `wrapper`'s kernel time that its byte bound takes, over
    the lanes of the window's dispatches. None where the kernel did not
    run, or where the dispatches' launches differ from the wrapper's
    count (the lanes would then not be the kernel's)."""
    prof, spans = run.get("prof"), run.get("spans")
    if prof is None or spans is None:
        return None
    entry = run["entry"]
    if entry.launches(spans) != prof["counted"][wrapper]:
        print(f"portbench: {wrapper}: {entry.launches(spans)} launches by "
              f"the dispatches, {prof['counted'][wrapper]} counted; no "
              f"roofline share", file=sys.stderr)
        return None
    name = KERNELS[wrapper]
    sec = sum(s for k, (s, _) in prof["by_name"].items() if name in k)
    return roofline.share(BYTES[wrapper](entry.lanes(spans)), sec)
