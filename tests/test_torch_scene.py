"""The port's compiled scene against the JAX package's: every array the
port keeps is equal, and scene_from_arrays takes the JAX package's arrays
as they are. Also: no module of the port imports jax or craytpu."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_buf as jload_buf
from craytpu.scene.sceneloader import load_scene_from_file as jload
from craytpu_torch.scene.compile import (compile_scene, scene_arrays,
                                         scene_from_arrays)
from craytpu_torch.scene.sceneloader import load_scene_from_buf
from craytpu_torch.scene.sceneloader import load_scene_from_file
from tests.test_render_smoke import SPHERE_SCENE

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ["entry_scene", "stress_instances", "sphere"]


def load_pair(name, overrides=None):
    """(craytpu SceneHost, craytpu_torch SceneHost) of one scene."""
    ov = dict(overrides or {})
    if name == "sphere":
        buf = json.dumps(SPHERE_SCENE)
        return jload_buf(buf, "", ov), load_scene_from_buf(buf, "", ov)
    path = os.path.join(REPO, "assets", f"{name}.json")
    return jload(path, ov), load_scene_from_file(path, ov)


def jax_arrays(cs) -> dict:
    """numpy copies of a craytpu CompiledScene, keyed as the port's
    scene_from_arrays takes them."""
    out = {f"geom.{k}": np.asarray(v) for k, v in cs.geom._asdict().items()}
    out.update({f"shade.{k}": np.asarray(v)
                for k, v in cs.shade._asdict().items()})
    out.update({f"params.{k}": np.asarray(v)
                for k, v in cs.params._asdict().items()})
    dm = cs.dense_meta
    lights = dm["lights"] or {
        "kind": np.zeros(0, np.int32), "mat": np.zeros(0, np.int32),
        "p0": np.zeros((0, 3), np.float32), "e1": np.zeros((0, 3), np.float32),
        "e2": np.zeros((0, 3), np.float32), "n": np.zeros((0, 3), np.float32),
        "area": np.zeros(0, np.float32)}
    out.update({f"lights.{k}": np.asarray(v) for k, v in lights.items()
                if k != "count"})
    out.update(mat_graph=np.asarray(cs.mat_graph),
               lights_mat_mask=np.asarray(dm["lights_mat_mask"]),
               mat_nee=np.asarray(dm["mat_nee"]),
               diffuse_color_ir=dm["diffuse_color_ir"],
               tri_wide=np.asarray(dm["tri_wide"]),
               inst_wide=np.asarray(dm["inst_wide"]),
               sphere_uv=dm["sphere_uv"], graphs=cs.graphs, bg_ir=cs.bg_ir,
               camera=cs.camera, prefs=cs.prefs, tlas_end=cs.tlas_end,
               stack_depth=cs.stack_depth, n_instances=cs.n_instances,
               max_leaf_tris=cs.max_leaf_tris,
               max_leaf_inst=cs.max_leaf_inst,
               reg={"colors": cs.reg._colors, "values": cs.reg._values,
                    "vecs": cs.reg._vecs, "tex_meta": cs.reg.tex_meta})
    return out


def ir_equal(a, b) -> bool:
    """Structural equality of material IRs (param tables are arrays)."""
    seq = (tuple, list)
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys()
                and all(ir_equal(a[k], b[k]) for k in a))
    if isinstance(a, seq) or isinstance(b, seq):
        return (isinstance(a, seq) and isinstance(b, seq)
                and len(a) == len(b)
                and all(ir_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def assert_same(want: dict, got: dict):
    for k, v in want.items():
        if k in ("camera", "prefs"):
            continue
        g = got[k]
        if k in ("graphs", "bg_ir", "diffuse_color_ir"):
            assert ir_equal(v, g), k
        elif isinstance(v, np.ndarray):
            assert g.dtype == v.dtype and g.shape == v.shape, \
                (k, g.dtype, v.dtype, g.shape, v.shape)
            assert np.array_equal(g.view(np.uint8), v.view(np.uint8)), k
        elif k == "reg":
            for f in ("colors", "values", "vecs"):
                assert list(g[f]) == list(v[f]), f
            assert [tuple(m) for m in g["tex_meta"]] == \
                [tuple(m) for m in v["tex_meta"]]
        else:
            assert g == v, (k, g, v)


@pytest.fixture(scope="module", params=SCENES)
def compiled_pair(request):
    jscene, tscene = load_pair(request.param, {"width": 40, "height": 30})
    return jcompile(jscene), compile_scene(tscene, "cpu")


def test_compiled_arrays_equal(compiled_pair):
    jcs, tcs = compiled_pair
    assert_same(jax_arrays(jcs), scene_arrays(tcs))


def test_scene_from_arrays_round_trip(compiled_pair):
    """The JAX package's arrays -> the port's scene -> the same arrays,
    with the same compiled shading (registry slots included)."""
    jcs, tcs = compiled_pair
    want = jax_arrays(jcs)
    cs = scene_from_arrays(want, "cpu")
    assert_same(want, scene_arrays(cs))
    assert cs.reg.keys() == tcs.reg.keys()
    # compiling the graphs again registers nothing new
    n_colors = len(cs.reg.keys()["colors"])
    cs.bsdf_fns("random")
    cs.background_fn()
    assert len(cs.reg.keys()["colors"]) == n_colors


def test_port_imports_no_jax_or_craytpu():
    """Every module of craytpu_torch imports with jax and craytpu blocked
    in sys.modules; so does chip_smoke.py."""
    pkg = os.path.join(REPO, "craytpu_torch")
    mods = sorted(
        os.path.relpath(os.path.join(root, f), REPO)[:-3]
        .replace(os.sep, ".").removesuffix(".__init__")
        for root, _, files in os.walk(pkg) for f in files
        if f.endswith(".py"))
    code = ("import sys, importlib, runpy\n"
            "for blocked in ('jax', 'jaxlib', 'craytpu'):\n"
            "    sys.modules[blocked] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'craytpu.'))"
            " for k, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(mods) > 20
