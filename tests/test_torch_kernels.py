"""Each CUDA kernel of the port against its plain PyTorch version, bit for
bit (NaN == NaN), on in-repo scenes. Needs a CUDA device; skips without
one. Imports neither jax nor craytpu, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from craytpu_torch.ops import cuda_build
from craytpu_torch.ops import hitrec as hr
from craytpu_torch.ops import traverse as trv
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.scene.sceneloader import load_scene_from_file

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", params=["entry_scene", "stress_instances"])
def scene(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = os.path.join(ASSETS, f"{request.param}.json")
    return compile_scene(load_scene_from_file(path, {"width": 32,
                                                     "height": 24}), "cpu")


def assert_bits(got, want, name):
    g = np.ascontiguousarray(got.cpu().numpy())
    w = np.ascontiguousarray(want.cpu().numpy())
    bad = (g.view(np.uint32) != w.view(np.uint32)) & ~(np.isnan(g)
                                                        & np.isnan(w))
    assert not bad.any(), f"{name}: {bad.sum()} of {bad.size} differ"


def rays(cs, B, seed):
    rng = np.random.default_rng(seed)
    bb = cs.geom.node_bounds[0].numpy()
    lo, hi = bb[[0, 2, 4]], bb[[1, 3, 5]]
    o = rng.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo),
                    (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def test_closest_hit_kernel_matches_plain(scene):
    B = 8192
    o, d = rays(scene, B, 11)
    limit = torch.where(torch.arange(B) % 7 == 0, 0.0, trv.FLT_MAX)
    args = (scene.tlas_end, scene.stack_depth)
    want = trv.closest_hit(scene.geom, o, d, limit, *args)
    n = trv.closest_hit.launches
    with cuda_build.launch_timing() as times:
        got = trv.closest_hit(scene.geom.to("cuda"), o.cuda(), d.cuda(),
                              limit.cuda(), *args)
    assert trv.closest_hit.launches == n + 1
    assert len(times["closest_hit"]) == 1 and times["closest_hit"][0] > 0
    assert (want.inst >= 0).any()
    assert torch.equal(got.inst.cpu(), want.inst)
    assert torch.equal(got.prim.cpu(), want.prim)
    assert_bits(got.t, want.t, "t")


@pytest.mark.parametrize("sphere_uv", [False, True])
def test_hitrec_kernel_matches_plain(scene, sphere_uv):
    B = 8192
    rng = np.random.default_rng(5)
    o, d = rays(scene, B, 5)
    P, I = scene.tri_wide.shape[0], scene.inst_wide.shape[0]
    args = (o, d, torch.from_numpy(rng.uniform(0, 20, B).astype(np.float32)),
            torch.from_numpy(rng.integers(-1, P, B, dtype=np.int32)),
            torch.from_numpy(rng.integers(-1, I, B, dtype=np.int32)))
    want = hr.hitrec_record(scene.tri_wide, scene.inst_wide, *args,
                            sphere_uv)
    n = hr.hitrec_record.launches
    got = hr.hitrec_record(scene.tri_wide.cuda(), scene.inst_wide.cuda(),
                           *[a.cuda() for a in args], sphere_uv)
    torch.cuda.synchronize()
    assert hr.hitrec_record.launches == n + 1
    assert_bits(got, want, "record")


def test_kernels_refuse_bad_input(scene):
    o, d = rays(scene, 64, 1)
    limit = torch.full((64,), trv.FLT_MAX, device="cuda")
    with pytest.raises(ValueError):
        trv.closest_hit(scene.geom.to("cuda"), o.double().cuda(), d.cuda(),
                        limit, scene.tlas_end, scene.stack_depth)
    with pytest.raises(ValueError):
        trv.closest_hit(scene.geom.to("cuda"), o.cuda(), d.cuda(), limit,
                        scene.tlas_end, trv.KERNEL_MAX_STACK + 1)
