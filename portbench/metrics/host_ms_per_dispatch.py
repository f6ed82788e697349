"""host_ms_per_dispatch (program span, host clock): the host's mean
milliseconds a dispatch of the entry's loop (the pool step) takes to
return, over the traced run's whole requests timed before the profiler
starts (host spans around the dispatches, no profiler): its queueing, or
its wait where the launch queue is full."""


def read(run):
    st = run.get("timed_spans")
    if st is None:
        return None
    s = st.stats.get(run["entry_mod"].DISPATCH_SPAN)
    if not s or not s["n"]:
        return None
    return 1e3 * s["s"] / s["n"]
