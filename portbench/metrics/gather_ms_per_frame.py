"""gather_ms_per_frame (device trace): device milliseconds a frame of
gather, index and scatter kernels (table gathers such as
vecmath.take_rows, the pool's permutes, the flush), by kernel name."""

from portbench.kernel_names import is_gather


def read(run):
    prof = run.get("prof")
    if prof is None:
        return None
    s = sum(sec for name, (sec, _) in prof["by_name"].items()
            if is_gather(name))
    return 1e3 * s / run["requests"] if s > 0 else None
