"""setup_s (host clock): process start to the first timed request: import,
kernel build or load, scene load and BVH build, compile_scene, graph
captures and the warm-up requests."""


def read(run):
    return run["setup_s"]
