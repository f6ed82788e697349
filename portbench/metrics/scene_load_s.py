"""scene_load_s (host clock, set-up): the scene front end, JSON and OBJ
load, BVH build (scene/sceneloader.py, accel/build.py) and
scene/compile.py::compile_scene, as the entry pays them once in set-up."""


def read(run):
    return run["facts"]["scene_load_s"]
