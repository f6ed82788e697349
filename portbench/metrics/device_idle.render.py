"""device_idle.render (device trace): 100 - the per cent of the traced
window (whole requests of a render entry) in which some operation ran on
the device."""


def read(run):
    prof = run.get("prof")
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
