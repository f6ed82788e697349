"""graph_capture_s (host clock, set-up): seconds in the dispatch layer's
CUDA graph captures during set-up (utils/graphs.py::GraphCache._capture:
each key's first call, its eager run and its capture)."""


def read(run):
    return run["facts"]["graph_capture_s"]
