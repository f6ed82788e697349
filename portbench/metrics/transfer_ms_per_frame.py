"""transfer_ms_per_frame (program span): host milliseconds a frame in the
entry's copies between host and card, which block the host: the spans
`upload` (the resumed sum's copy to the card, the framebuffer's copy into
the static buffer) and `fetch` (the division and the frame's copy to
pageable host memory), from the program's frame records of the traced
window (frame_records.py)."""

from portbench.frame_records import per_frame

SPANS = ("upload", "fetch")


def read(run):
    return per_frame(run, lambda r: sum(
        s["t1_ms"] - s["t0_ms"] for s in r["spans"] if s["name"] in SPANS))
