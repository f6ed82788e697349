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
from craytpu_torch.ops import dense_isect as dx
from craytpu_torch.ops import hitrec as hr
from craytpu_torch.ops import traverse as trv
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.scene.device import INST_SPHERE
from craytpu_torch.scene.sceneloader import load_scene_from_file
from tests.torch_dense_rays import (DUPLICATES, FLAT_INSTANCES, aimed_rays,
                                    face_plane_rays, flat_rays,
                                    floor_edge_rays, floor_scene, graze_rays,
                                    near_plane_rays, tangent_rays,
                                    tie_scene)

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


def on_card(cs):
    """The scene's geometry and K2 layout on the card."""
    geom = cs.geom.to("cuda")
    return geom, trv.build_layout(geom, cs.tlas_end)


def check_closest_hit(cs, o, d, limit, stack_depth):
    """K2 on the card against the plain version on the CPU, bit for bit;
    returns the plain result."""
    args = (cs.tlas_end, stack_depth)
    want = trv.closest_hit(cs.geom, o, d, limit, *args)
    geom, layout = on_card(cs)
    got = trv.closest_hit(geom, o.cuda(), d.cuda(), limit.cuda(), *args,
                          layout)
    torch.cuda.synchronize()
    assert torch.equal(got.inst.cpu(), want.inst)
    assert torch.equal(got.prim.cpu(), want.prim)
    assert_bits(got.t, want.t, "t")
    return want


def test_closest_hit_kernel_matches_plain(scene):
    B = 8192
    o, d = rays(scene, B, 11)
    limit = torch.where(torch.arange(B) % 7 == 0, 0.0, trv.FLT_MAX)
    args = (scene.tlas_end, scene.stack_depth)
    want = trv.closest_hit(scene.geom, o, d, limit, *args)
    geom, layout = on_card(scene)
    n = trv.closest_hit.launches
    with cuda_build.launch_timing() as times:
        got = trv.closest_hit(geom, o.cuda(), d.cuda(), limit.cuda(), *args,
                              layout)
    assert trv.closest_hit.launches == n + 1
    assert len(times["closest_hit"]) == 1
    assert times["closest_hit"][0][0] == B and times["closest_hit"][0][1] > 0
    assert (want.inst >= 0).any()
    assert torch.equal(got.inst.cpu(), want.inst)
    assert torch.equal(got.prim.cpu(), want.prim)
    assert_bits(got.t, want.t, "t")


@pytest.mark.parametrize("depth", [1, 3, 8])
def test_closest_hit_kernel_drops_pushes_as_plain(scene, depth):
    """A small stack: pushes are dropped, in both versions alike."""
    o, d = rays(scene, 4096, 12)
    limit = torch.full((4096,), trv.FLT_MAX)
    shallow = check_closest_hit(scene, o, d, limit, depth)
    deep = trv.closest_hit(scene.geom, o, d, limit, scene.tlas_end,
                           scene.stack_depth)
    if depth < 8 and scene.geom.node_bounds.shape[0] > 100:
        # stress_instances: the dropped pushes change some winners
        assert not torch.equal(shallow.inst, deep.inst)


@pytest.mark.parametrize("B", [0, 1, 127, 129, 65539])
def test_closest_hit_kernel_ragged_batches(scene, B):
    o, d = rays(scene, B, 13)
    limit = torch.where(torch.arange(B) % 5 == 3, 0.0, trv.FLT_MAX)
    n = trv.closest_hit.launches
    want = check_closest_hit(scene, o, d, limit, scene.stack_depth)
    assert want.t.shape == (B,)
    assert trv.closest_hit.launches == n + (B > 0)


def test_closest_hit_kernel_all_dead(scene):
    o, d = rays(scene, 1000, 14)
    want = check_closest_hit(scene, o, d, torch.zeros(1000),
                             scene.stack_depth)
    assert (want.inst == -1).all() and (want.prim == -1).all()


def check_hitrec(cs, args, sphere_uv):
    want = hr.hitrec_record(cs.tri_wide, cs.inst_wide, *args, sphere_uv)
    got = hr.hitrec_record(cs.tri_wide.cuda(), cs.inst_wide.cuda(),
                           *[a.cuda() for a in args], sphere_uv)
    torch.cuda.synchronize()
    assert_bits(got, want, "record")


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


@pytest.mark.parametrize("ids", ["misses", "spheres"])
def test_hitrec_kernel_special_ids(scene, ids):
    """Every id -1 (all misses), or only sphere winners (prim -1)."""
    B = 1000  # a ragged last warp
    rng = np.random.default_rng(6)
    o, d = rays(scene, B, 6)
    t_k = torch.from_numpy(rng.uniform(0, 20, B).astype(np.float32))
    prim = torch.full((B,), -1, dtype=torch.int32)
    if ids == "misses":
        inst = torch.full((B,), -1, dtype=torch.int32)
    else:
        sph = torch.nonzero(scene.geom.inst_kind == INST_SPHERE).squeeze(1)
        assert sph.numel() > 0
        inst = sph[torch.from_numpy(rng.integers(0, sph.numel(), B))]
        inst = inst.to(torch.int32)
    for sphere_uv in (False, True):
        check_hitrec(scene, (o, d, t_k, prim, inst), sphere_uv)


def test_kernels_refuse_bad_input(scene):
    o, d = rays(scene, 64, 1)
    limit = torch.full((64,), trv.FLT_MAX, device="cuda")
    geom, layout = on_card(scene)
    with pytest.raises(ValueError):
        trv.closest_hit(geom, o.double().cuda(), d.cuda(), limit,
                        scene.tlas_end, scene.stack_depth, layout)
    with pytest.raises(ValueError):
        trv.closest_hit(geom, o.cuda(), d.cuda(), limit, scene.tlas_end,
                        trv.KERNEL_MAX_STACK + 1, layout)
    with pytest.raises(ValueError):  # no layout
        trv.closest_hit(geom, o.cuda(), d.cuda(), limit, scene.tlas_end,
                        scene.stack_depth)
    # every stack depth up to the kernel's is taken
    check_closest_hit(scene, o, d, limit.cpu(), trv.KERNEL_MAX_STACK)


def check_dense_hit(cs, o, d, limit):
    """K3 on the card against its plain version on the CPU, bit for bit;
    returns the plain result."""
    want = dx.dense_hit(cs.geom, o, d, limit, cs.dense)
    geom = cs.geom.to("cuda")
    got = dx.dense_hit(geom, o.cuda(), d.cuda(), limit.cuda(),
                       dx.build_dense(geom, cs.n_instances))
    torch.cuda.synchronize()
    assert torch.equal(got.inst.cpu(), want.inst)
    assert torch.equal(got.prim.cpu(), want.prim)
    assert_bits(got.t, want.t, "t")
    return want


def test_dense_hit_kernel_matches_plain(scene):
    """Every 7th lane dead, and the whole first block (a block whose lanes
    are all dead returns at once)."""
    B = 4096
    o, d = rays(scene, B, 21)
    i = torch.arange(B)
    limit = torch.where((i % 7 == 0) | (i < 256), 0.0, trv.FLT_MAX)
    n = dx.dense_hit.launches
    want = check_dense_hit(scene, o, d, limit)
    assert dx.dense_hit.launches == n + 1
    assert (want.inst >= 0).any() and (want.prim >= 0).any()
    assert (want.inst[:256] == -1).all()


@pytest.mark.parametrize("B", [0, 1, 255, 257, 4099])
def test_dense_hit_kernel_ragged_batches(scene, B):
    o, d = rays(scene, B, 22)
    limit = torch.where(torch.arange(B) % 5 == 3, 0.0, trv.FLT_MAX)
    n = dx.dense_hit.launches
    want = check_dense_hit(scene, o, d, limit)
    assert want.t.shape == (B,)
    assert dx.dense_hit.launches == n + (B > 0)


def test_dense_hit_kernel_all_dead(scene):
    o, d = rays(scene, 1000, 23)
    want = check_dense_hit(scene, o, d, torch.zeros(1000))
    assert (want.inst == -1).all() and (want.prim == -1).all()


def test_dense_hit_kernel_refuses_bad_input(scene):
    o, d = rays(scene, 64, 2)
    limit = torch.full((64,), trv.FLT_MAX, device="cuda")
    geom = scene.geom.to("cuda")
    dense = dx.build_dense(geom, scene.n_instances)
    with pytest.raises(ValueError):
        dx.dense_hit(geom, o.double().cuda(), d.cuda(), limit, dense)
    with pytest.raises(ValueError):  # the table on the wrong device
        dx.dense_hit(geom, o.cuda(), d.cuda(), limit, scene.dense)


def check_dense_variant(cs, o, d, limit, fast, monkeypatch):
    """K3 against its plain version on (o, d, limit) in the exact variant
    (the plain version on the CPU) or the fast one (both on the card);
    returns the plain result."""
    if not fast:
        return check_dense_hit(cs, o, d, limit)
    monkeypatch.setattr(vm, "_FASTMATH", True)
    geom = cs.geom.to("cuda")
    dense = dx.build_dense(geom, cs.n_instances)
    o, d, limit = o.cuda(), d.cuda(), limit.cuda()
    got = dx.dense_hit(geom, o, d, limit, dense)
    want = dx.dense_hit_plain(geom, dense, o, d, limit)
    torch.cuda.synchronize()
    assert ("dense_hit", True) in cuda_build._LIBS
    assert torch.equal(got.inst, want.inst)
    assert torch.equal(got.prim, want.prim)
    assert_bits(got.t, want.t, "t")
    return want


@pytest.mark.parametrize("fast", [False, True])
def test_dense_hit_kernel_on_grazing_rays(scene, fast, monkeypatch):
    """Rays aimed at triangle edges, vertices and group-box faces (the
    cull's margins), every 9th lane dead; on stress_instances a search
    over 64 mesh instances. Bit-equal in both variants."""
    o, d = (torch.from_numpy(x) for x in aimed_rays(
        scene, np.random.default_rng(41), 3000))
    limit = torch.where(torch.arange(3000) % 9 == 4, 0.0, trv.FLT_MAX)
    want = check_dense_variant(scene, o, d, limit, fast, monkeypatch)
    assert (want.prim >= 0).float().mean() > 0.3


@pytest.mark.parametrize("fast", [False, True])
def test_dense_hit_kernel_on_tangent_rays(fast, monkeypatch):
    """stress_highpoly's grazing rays: tangent to the sphere near its
    poles (slivers, boxes with F > 1) and along its silhouette, and
    through slivers at THETA to 4 THETA off their plane, every 9th lane
    dead. Bit-equal in both variants."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cs = compile_scene(load_scene_from_file(
        os.path.join(ASSETS, "stress_highpoly.json"),
        {"width": 32, "height": 24}), "cpu")
    rng = np.random.default_rng(43)
    rays = [tangent_rays(cs, rng, 1000, "poles"),
            tangent_rays(cs, rng, 1000, "silhouette"),
            near_plane_rays(cs, rng, 1000, dx.THETA, 4 * dx.THETA)]
    o = torch.from_numpy(np.concatenate([r[0] for r in rays]))
    d = torch.from_numpy(np.concatenate([r[1] for r in rays]))
    limit = torch.where(torch.arange(3000) % 9 == 4, 0.0, trv.FLT_MAX)
    want = check_dense_variant(cs, o, d, limit, fast, monkeypatch)
    assert (want.prim >= 0).float().mean() > 0.3


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", ["floor", "stress_highpoly"])
def test_dense_hit_kernel_on_plane_rays(tmp_path, name, fast, monkeypatch):
    """Rays at 0 to THETA off a triangle's plane (graze_rays: in the plane,
    1e-8 ... 1e-3 rad and up to THETA; through the triangle and beside
    it, from 0.2-3 and 50-400 units): on the tilted floor, with rays in its
    plane beside it that only rounding hits, and on stress_highpoly's
    slivers; every 9th lane dead. Bit-equal in both variants."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(44)
    if name == "floor":
        cs, share, B = floor_scene(tmp_path), 1.0, 400
        rays = [floor_edge_rays(rng, B, (0.2, 3.0))]
    else:
        cs, share, B = compile_scene(load_scene_from_file(
            os.path.join(ASSETS, "stress_highpoly.json"),
            {"width": 32, "height": 24}), "cpu"), 0.02, 200
        rays = []
    rays += [graze_rays(cs, rng, B, where, dist, share)
             for where in ("through", "beside")
             for dist in ((0.2, 3.0), (50.0, 400.0))]
    o = torch.from_numpy(np.concatenate([r[0] for r in rays]))
    d = torch.from_numpy(np.concatenate([r[1] for r in rays]))
    limit = torch.where(torch.arange(o.shape[0]) % 9 == 4, 0.0, trv.FLT_MAX)
    want = check_dense_variant(cs, o, d, limit, fast, monkeypatch)
    assert (want.prim >= 0).float().mean() > 0.2


@pytest.mark.parametrize("fast", [False, True])
def test_dense_hit_kernel_on_ties(tmp_path, fast, monkeypatch):
    """The tie scene (a grid mesh with duplicate triangles, two instances
    at one place; a flat grid twice, one cell apart): equal t across
    instances, between duplicates and on shared edges, and rays in
    box-face planes. Bit-equal in both
    variants; the first instance and the original triangles win."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cs = tie_scene(tmp_path)
    rng = np.random.default_rng(42)
    o, d = aimed_rays(cs, rng, 2000)
    o2, d2 = face_plane_rays(cs, rng, 700)
    o3, d3 = flat_rays(rng, 300)
    o = torch.from_numpy(np.concatenate([o, o2, o3]))
    d = torch.from_numpy(np.concatenate([d, d2, d3]))
    want = check_dense_variant(cs, o, d, torch.full((3000,), trv.FLT_MAX),
                               fast, monkeypatch)
    assert (want.inst == 0).any() and not (want.inst == 1).any()
    assert (want.inst[-300:] == FLAT_INSTANCES[0]).all()
    assert not ((want.prim >= DUPLICATES[0][0])
                & (want.prim <= DUPLICATES[-1][0])).any()


@pytest.mark.parametrize("kernel", ["closest_hit", "hitrec", "dense_hit"])
def test_fast_variant_matches_fast_plain(scene, kernel, monkeypatch):
    """Under CRAYTPU_FASTMATH each wrapper loads its kernel's fast
    variant (-DCRAYTPU_FASTMATH=1, a library of its own), bit-equal to
    the plain version under the same flag. Both run on the card: on the
    CPU, PyTorch's float sqrt can be 1 ulp off the IEEE root."""
    monkeypatch.setattr(vm, "_FASTMATH", True)
    B = 4096
    o, d = rays(scene, B, 31)
    o, d = o.cuda(), d.cuda()
    geom = scene.geom.to("cuda")
    limit = torch.where(torch.arange(B, device="cuda") % 7 == 0, 0.0,
                        trv.FLT_MAX)
    if kernel == "closest_hit":
        args = (scene.tlas_end, scene.stack_depth)
        got = trv.closest_hit(geom, o, d, limit, *args,
                              trv.build_layout(geom, scene.tlas_end))
        want = trv.traverse_plain(geom, o, d, limit, *args)
    elif kernel == "dense_hit":
        dense = dx.build_dense(geom, scene.n_instances)
        got = dx.dense_hit(geom, o, d, limit, dense)
        want = dx.dense_hit_plain(geom, dense, o, d, limit)
    else:
        rng = np.random.default_rng(32)
        P, I = scene.tri_wide.shape[0], scene.inst_wide.shape[0]
        ids = (torch.from_numpy(rng.uniform(0, 20, B).astype(np.float32)),
               torch.from_numpy(rng.integers(-1, P, B, dtype=np.int32)),
               torch.from_numpy(rng.integers(-1, I, B, dtype=np.int32)))
        tw, iw = scene.tri_wide.cuda(), scene.inst_wide.cuda()
        args = (o, d) + tuple(x.cuda() for x in ids)
        got = hr.hitrec_record(tw, iw, *args, True)
        want = hr.hitrec_plain(tw, iw, *args, True)
    torch.cuda.synchronize()
    assert (kernel, True) in cuda_build._LIBS
    if kernel == "hitrec":
        assert_bits(got, want, "record")
        return
    assert (want.inst >= 0).any()
    assert torch.equal(got.inst, want.inst)
    assert torch.equal(got.prim, want.prim)
    assert_bits(got.t, want.t, "t")


# ---- the forward dispatches as CUDA graphs (utils/graphs.py): a replay
# runs the kernels and ops its capture recorded, so what it computes is
# bit for bit what the eager path computes on the same inputs

def card_renderer(name="stress_highpoly", graphs=True, **kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs")
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    cs = compile_scene(load_scene_from_file(
        os.path.join(ASSETS, f"{name}.json"),
        {"width": 80, "height": 50, "samples": 4}), "cuda")
    return WavefrontRenderer(cs, graphs=graphs, **kw)


def assert_pools_equal(a, b):
    for f in ("o", "d", "weight", "delta"):
        assert_bits(getattr(a, f), getattr(b, f), f)
    for f in ("alive", "lane", "lpass", "pdepth"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("pcg_hi", "pcg_lo", "curr_prime"):
        assert torch.equal(getattr(a.s, f), getattr(b.s, f)), f


def test_pool_step_replay_equals_eager_step():
    """Two steps of one bounce from the same primed pool: the graph
    renderer's second step is a replay; the pools stay bit-equal."""
    g = card_renderer()
    e = card_renderer(graphs=False)
    pools = []
    for r in (g, e):
        with r._forward(4):
            pool = r._prime_dev(4096, 0, 0, 4000, 4)
            for _ in range(2):
                pool, n = r._pool_step(1, pool)
        pools.append((pool, int(n)))
    torch.cuda.synchronize()
    assert g.graphs.replays >= 1 and e.graphs.replays == 0
    assert pools[0][1] == pools[1][1] > 0
    assert_pools_equal(pools[0][0], pools[1][0])


@pytest.mark.parametrize("path", ["persistent", "per_pass"])
def test_graph_frame_equals_eager_frame(path):
    """80x50, 4 spp: the graph renderer's second frame (all replays) is
    bit-equal to its first and to the eager renderer's frame."""
    g = card_renderer()
    e = card_renderer(graphs=False)

    def frame(r):
        return (r.render_persistent(4) if path == "persistent"
                else r.render(4))
    first = frame(g)
    caps = g.graphs.captures
    second = frame(g)
    assert g.graphs.captures == caps and g.graphs.replays > 0
    np.testing.assert_array_equal(second.view(np.uint32),
                                  first.view(np.uint32))
    np.testing.assert_array_equal(second.view(np.uint32),
                                  frame(e).view(np.uint32))


def test_capture_under_fast_math(monkeypatch):
    """CRAYTPU_FASTMATH (the fast kernel variants and the float layer's
    plain forms) captures, and its replays equal its eager frame."""
    monkeypatch.setattr(vm, "_FASTMATH", True)
    g = card_renderer()
    e = card_renderer(graphs=False)
    g.render_persistent(4)
    got = g.render_persistent(4)
    assert g.graphs.replays > 0 and ("closest_hit", True) in cuda_build._LIBS
    np.testing.assert_array_equal(got.view(np.uint32),
                                  e.render_persistent(4).view(np.uint32))


def test_replaced_params_recapture():
    """A renderer whose cscene.params is replaced captures afresh, and
    its image follows the new params (equal to an eager frame of them)."""
    from dataclasses import replace
    g = card_renderer("entry_scene")
    before = g.render_persistent(2)
    caps = g.graphs.captures
    p = g.cscene.params
    g.cscene.params = replace(p, colors=p.colors * 0.5,
                              emission=p.emission * 2.0)
    got = g.render_persistent(2)
    assert g.graphs.captures > caps
    assert not np.array_equal(got, before)
    e = card_renderer("entry_scene", graphs=False)
    e.cscene.params = g.cscene.params
    np.testing.assert_array_equal(got.view(np.uint32),
                                  e.render_persistent(2).view(np.uint32))
