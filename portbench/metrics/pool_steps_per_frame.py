"""pool_steps_per_frame (program counter): pool step dispatches
(WavefrontRenderer._pool_step, the drain's included) a frame of the
persistent pool, in the traced window."""


def read(run):
    st = run.get("spans")
    if st is None or "pool_step" not in st.stats:
        return None
    return st.stats["pool_step"]["n"] / run["requests"]
