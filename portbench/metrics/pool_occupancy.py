"""pool_occupancy (program counter): the per cent of the persistent pool's
launched lane-bounces (the sum of k * B over its steps) that were live,
over the traced window's frames, from the program's frame records
(frame_records.py). Live lane-bounces come from the live counts the pool
loop reads: exact for a step of one bounce, live-in * k (a bound) for
the drain's steps of k bounces."""

from portbench.frame_records import window_frames


def read(run):
    recs = window_frames(run)
    if recs is None:
        return None
    lanes = sum(r["counts"].get("lanes", 0) for r in recs)
    live = sum(r["counts"].get("live", 0) for r in recs)
    return 100.0 * live / lanes if lanes else None
