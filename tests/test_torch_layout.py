"""The closest-hit kernel's layout tables (ops/traverse.py::build_layout)
against what the closest-hit walk reads from Geometry, field by field, on
the in-repo scenes of tests/test_torch_isect.py: each inner node's record
holds both children's bounds, rows and counts (clamps included), and the
leaf-ordered triangle rows are tri_packed[prim_idx]. The tables built
from the JAX package's compiled arrays equal the port's, and a scene
builds them once."""

import os

import numpy as np
import pytest
import torch

from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_file as jload
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.ops import traverse as trv
from craytpu_torch.scene.compile import compile_scene, scene_from_arrays
from craytpu_torch.scene.sceneloader import load_scene_from_file
from tests.test_torch_detmath import assert_bits
from tests.test_torch_scene import jax_arrays

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
SIZE = {"width": 32, "height": 24}


@pytest.fixture(scope="module", params=["entry_scene", "stress_instances"])
def scenes(request):
    """(the JAX package's compiled scene, the port's, the scene file)"""
    path = os.path.join(ASSETS, f"{request.param}.json")
    return jcompile(jload(path, SIZE)), compile_scene(
        load_scene_from_file(path, SIZE), "cpu"), path


def check_records(geom, layout):
    """Every node's 64-byte record against the walk's reads of geom."""
    g = geom.numpy()
    M = g["node_bounds"].shape[0]
    rec = layout.node_rec.numpy()
    ints = rec.view(np.int32)[:, 12:16]  # (row, count) of each child
    assert rec.shape == (M, 16) and rec.dtype == np.float32
    inner = g["node_count"] <= 0
    # traverse_plain: left = min(row, M-1), right = min(left+1, M-1)
    left = np.minimum(g["node_child"], M - 1)[inner]
    right = np.minimum(left + 1, M - 1)
    assert_bits(rec[inner, 0:6], g["node_bounds"][left], "left bounds")
    assert_bits(rec[inner, 6:12], g["node_bounds"][right], "right bounds")
    want = np.stack([g["node_child"][left], g["node_count"][left],
                     g["node_child"][right], g["node_count"][right]], 1)
    np.testing.assert_array_equal(ints[inner], want)
    assert not rec.view(np.uint32)[~inner].any()  # leaves: no record
    return int(inner.sum())


def test_inner_node_records(scenes):
    _, cs, _ = scenes
    assert check_records(cs.geom, cs.layout) > 0


def test_inner_node_records_clamp_children(scenes):
    """An inner node whose left child is the last node, and one whose row
    lies past the array: both children clamp to node M-1, as in the walk."""
    _, cs, _ = scenes
    geom = cs.geom.to("cpu")
    geom.node_child = geom.node_child.clone()
    inner = torch.nonzero(geom.node_count <= 0).squeeze(1)
    M = geom.node_bounds.shape[0]
    geom.node_child[inner[0]] = M - 1
    geom.node_child[inner[-1]] = M + 7
    layout = trv.build_layout(geom, cs.tlas_end)
    check_records(geom, layout)
    for n in (inner[0], inner[-1]):
        assert_bits(layout.node_rec[n, 6:12], geom.node_bounds[M - 1],
                    "clamped right child")


def test_leaf_triangle_rows(scenes):
    _, cs, _ = scenes
    g = cs.geom.numpy()
    tri_leaf = cs.layout.tri_leaf.numpy()
    Q = g["prim_idx"].shape[0]
    assert tri_leaf.shape == (Q, 12) and tri_leaf.dtype == np.float32
    blas = np.zeros(Q, bool)
    for n in np.nonzero(g["node_count"] > 0)[0]:
        if n < cs.tlas_end:
            continue  # a TLAS leaf: its slots hold instance ids
        rows = g["node_child"][n] + np.arange(g["node_count"][n])
        blas[rows] = True
        assert_bits(tri_leaf[rows], g["tri_packed"][g["prim_idx"][rows]],
                    f"leaf {n}")
    assert blas.sum() == g["tri_packed"].shape[0]  # each triangle once
    assert not tri_leaf[~blas].view(np.uint32).any()


def test_layout_of_jax_arrays_equals_ports(scenes):
    """The tables built from the JAX package's compiled arrays (through
    scene_from_arrays) are the port's, bit for bit."""
    jcs, cs, _ = scenes
    other = scene_from_arrays(jax_arrays(jcs), "cpu").layout
    assert_bits(other.node_rec, cs.layout.node_rec, "node_rec")
    assert_bits(other.tri_leaf, cs.layout.tri_leaf, "tri_leaf")


def test_layout_built_once_per_scene(scenes, monkeypatch):
    """compile_scene's and scene_from_arrays' scenes build their tables
    at first use and never again: not per renderer, not per launch. A
    CPU render, whose plain walk reads Geometry, builds none."""
    jcs, _, path = scenes
    built = []
    build = trv.build_layout

    def counting(geom, tlas_end):
        built.append(tlas_end)
        return build(geom, tlas_end)

    monkeypatch.setattr(trv, "build_layout", counting)
    for cs in (compile_scene(load_scene_from_file(path, SIZE), "cpu"),
               scene_from_arrays(jax_arrays(jcs), "cpu")):
        n = len(built)
        WavefrontRenderer(cs, bounces=2).render(1)
        assert len(built) == n
        layout = cs.layout
        for _ in range(2):  # two renderers, two frames each
            ren = WavefrontRenderer(cs, bounces=2)
            ren.render(1)
            ren.render(1)
        assert len(built) == n + 1
        assert cs.layout is layout
