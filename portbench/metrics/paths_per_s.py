"""paths_per_s (host clock): pixels x samples of every request finished in
the window, over the window's wall seconds (requests back to back, the
window ending with the last request's output on the host)."""


def read(run):
    if "walls" not in run:
        return None
    return len(run["walls"]) * run["paths"] / run["window_s"]
