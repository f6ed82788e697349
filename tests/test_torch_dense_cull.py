"""K3's layout and cull (craytpu_torch/ops/dense_isect.py): the
leaf-ordered table and its boxes, the plain model of the kernel's box
decisions (`dense_cull_plain`) and the leaf-order search under the
kernel's tie rule, on the CPU. (K3 itself against its plain version on
the card: tests/test_torch_kernels.py.)

Bars:
  - the leaf-ordered table and its group, superblock and root boxes
    built from the JAX package's arrays equal the port's own, and the
    boxes are the JAX package's block bounds (build_tri_coeffs_T) of the
    leaf-ordered triangles, widened by an ulp;
  - each box's margin factor F is RHO / (THETA * mu_min), at least 1,
    of its triangles' least shape mu = |n| / L^2;
  - the cull never drops a pair that dense_hit_plain accepts with t at or
    below the ray's final best (its root, superblock and group votes
    hold), on rays aimed from a seed at triangle edges, vertices and the
    faces of group boxes, on rays that run in a box face's plane, and on
    stress_highpoly's grazing rays: tangent to the sphere near its poles
    (slivers) and along its silhouette, and through slivers at 1-4
    THETA to their plane;
  - the leaf-order search (`dense_cull_plain`'s hit) equals
    dense_hit_plain bit for bit, also on constructed ties: shared edges,
    duplicate triangles, and equal t in two instances of one mesh.
"""

import os

import numpy as np
import pytest
import torch

import craytpu.ops.dense_isect as jdense
from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_file as jload
from craytpu_torch.ops import dense_isect as dx
from craytpu_torch.ops import traverse as trv
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.scene.compile import compile_scene, scene_from_arrays
from craytpu_torch.scene.sceneloader import load_scene_from_file
from tests.test_torch_detmath import assert_bits
from tests.test_torch_scene import jax_arrays
from tests.torch_dense_rays import (DUPLICATES, FLAT_INSTANCES, aimed_rays,
                                    face_plane_rays, flat_rays,
                                    near_plane_rays, tangent_rays,
                                    tie_scene, world)

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
FLT_MAX = float(np.float32(3.4028235e38))
OV = {"width": 32, "height": 24}


def port_scene(name):
    return compile_scene(load_scene_from_file(
        os.path.join(ASSETS, f"{name}.json"), OV), "cpu")


@pytest.fixture(scope="module", params=["stress_instances",
                                        "stress_highpoly"])
def scene(request):
    return request.param, port_scene(request.param)


@pytest.fixture(scope="module")
def highpoly():
    return port_scene("stress_highpoly")


def check_cull(cs, o, d, limit=None):
    """dense_cull_plain against dense_hit_plain on (o, d): the hit bit
    for bit, and every pair the plain test accepts at or below the ray's
    final best inside a group whose votes (root, superblock, group) all
    hold. Returns (plain hit, accepted pairs)."""
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    B = o.shape[0]
    if limit is None:
        limit = torch.where(torch.arange(B) % 9 == 4, 0.0, FLT_MAX)
    dn = cs.dense
    want = dx.dense_hit_plain(cs.geom, dn, o, d, limit)
    got, culls = dx.dense_cull_plain(cs.geom, dn, o, d, limit)
    assert torch.equal(got.inst, want.inst)
    assert torch.equal(got.prim, want.prim)
    assert_bits(got.t.numpy(), want.t.numpy(), "t")
    best = torch.where(limit > 0.0, want.t, -1.0)
    plan = dn.plan.tolist()
    accepted = 0
    for c in culls:
        i = c["inst"]
        _, first, n, _ = plan[i]
        oi, di = trv.object_ray(cs.geom.inst_Ainv[i], cs.geom.inst_offset[i],
                                o, d)
        t, valid = dx.pair_tests(dn.leaf_table[first:first + n], oi, di,
                                 vm.vcross(di, oi))
        acc = valid & (t <= best[:, None])
        r, row = torch.nonzero(acc, as_tuple=True)
        accepted += r.numel()
        g = row // dx.GROUP
        kept = c["root"][r] & c["block"][r, g // dx.SUPER] & c["group"][r, g]
        assert bool(kept.all()), (
            f"instance {i}: {int((~kept).sum())} accepted pairs culled, "
            f"e.g. ray {int(r[~kept][0])} row {int(row[~kept][0])}")
    return want, accepted


def test_layout_matches_jax_package(scene):
    """The leaf-ordered table, ids and boxes from the JAX package's
    arrays (as a cluster worker gets them) equal the port's own; each
    mesh's rows are its BLAS leaf order, a permutation of its ids,
    regrouped into superblocks and groups (leaf_groups of the JAX
    package's triangles); the
    superblock and group boxes are build_tri_coeffs_T's block bounds of
    the leaf-ordered triangles at 256 and 32 triangles a block, widened
    by one ulp outward; V bounds the box's coordinates."""
    name, tcs = scene
    jcs = jcompile(jload(os.path.join(ASSETS, f"{name}.json"), OV))
    mine, theirs = tcs.dense, scene_from_arrays(jax_arrays(jcs), "cpu").dense
    for f in ("table", "leaf_table", "root_box", "block_box", "group_box"):
        assert_bits(getattr(theirs, f).numpy(), getattr(mine, f).numpy(), f)
    for f in ("plan", "leaf_ids", "mesh_index"):
        assert torch.equal(getattr(theirs, f), getattr(mine, f)), f
    assert_bits(mine.leaf_table.numpy(),
                mine.table[mine.leaf_ids.long()].numpy(), "rows")
    tri = np.asarray(jcs.geom.tri_packed)
    child, count = (np.asarray(jcs.geom.node_child),
                    np.asarray(jcs.geom.node_count))
    prim, roots = np.asarray(jcs.geom.prim_idx), np.asarray(
        jcs.geom.blas_root)
    ends = sorted(int(r) for r in roots if r >= 0) + [child.shape[0]]
    n_checked = 0
    for m, (base, n) in enumerate(dx.mesh_rows(tcs.geom)):
        if n == 0:
            continue
        # the JAX package's BLAS leaf slots of mesh m, in node order
        r = int(roots[m])
        nodes = np.arange(r, ends[ends.index(r) + 1])
        leaf = nodes[count[nodes] > 0]
        slots = np.concatenate([np.arange(child[k], child[k] + count[k])
                                for k in leaf])
        ids = mine.leaf_ids[base:base + n].numpy()
        assert np.array_equal(np.sort(slots), np.arange(slots.min(),
                                                        slots.max() + 1))
        # the BLAS leaf order regrouped (leaf_groups of the JAX package's
        # triangles): the same superblocks' rows when a mesh has fewer
        # than SUPER superblocks' worth of them
        order = dx.leaf_groups(prim[np.sort(slots)], dx.tri_normals(tri),
                               *dx.tri_bounds(tri))
        assert np.array_equal(ids, order)
        for a in range(0, n, dx.TILE * dx.SUPER):
            assert (np.sort(ids[a:a + dx.TILE * dx.SUPER])
                    == np.sort(prim[np.sort(slots)][a:a + dx.TILE
                                                    * dx.SUPER])).all()
        assert sorted(ids) == list(range(base, base + n))
        sb0, g0 = mine.mesh_index[m].tolist()
        for size, boxes, first in ((dx.TILE, mine.block_box, sb0),
                                   (dx.GROUP, mine.group_box, g0)):
            old = jdense.TRI_BLOCK
            jdense.TRI_BLOCK = size
            try:
                _, bb = jdense.build_tri_coeffs_T(tri[ids])
            finally:
                jdense.TRI_BLOCK = old
            got = boxes[first:first + bb.shape[0]].numpy()
            lo = np.nextafter(bb[:, [0, 2, 4]], np.float32(-np.inf))
            hi = np.nextafter(bb[:, [1, 3, 5]], np.float32(np.inf))
            assert_bits(got[:, 0:3], lo, f"{size} lo")
            assert_bits(got[:, 4:7], hi, f"{size} hi")
            assert (got[:, 3] >= np.abs(got[:, [0, 1, 2, 4, 5, 6]]).max(1)
                    ).all()
        root = mine.root_box[m].numpy()
        assert_bits(root[0:3], mine.group_box[g0:g0 + -(-n // dx.GROUP),
                                              0:3].numpy().min(0), "root")
        n_checked += 1
    assert n_checked > 0


def test_cull_keeps_every_accepted_pair_on_aimed_rays(scene):
    """Rays aimed at triangle edges, vertices and group-box faces: no
    pair that the plain test accepts at or below the final best is
    culled, and the leaf-order search equals the plain one."""
    name, cs = scene
    rng = np.random.default_rng(101)
    o, d = aimed_rays(cs, rng, 384 if name == "stress_instances" else 192)
    want, accepted = check_cull(cs, o, d)
    assert (want.prim >= 0).float().mean() > 0.3  # the rays do hit
    assert accepted > 100


def test_cull_prunes(scene, monkeypatch):
    """The cull does cull: on rays aimed at the mesh a lane's slab test
    votes for a small share of the groups, the plane test adds votes
    only to what the slab test skips (dense_hit.cu's header: its cone
    of normals keeps many boxes of a displaced or closed mesh), and a
    dead lane votes for none."""
    name, cs = scene
    rng = np.random.default_rng(102)
    o, d = (torch.from_numpy(x) for x in aimed_rays(cs, rng, 96))
    limit = torch.where(torch.arange(96) % 4 == 0, 0.0, FLT_MAX)
    _, culls = dx.dense_cull_plain(cs.geom, cs.dense, o, d, limit)
    group = torch.cat([c["group"] for c in culls], 1)
    monkeypatch.setattr(dx, "plane_keep",
                        lambda box, o, cr: torch.zeros(
                            (o.shape[0], box.shape[0]), dtype=torch.bool))
    _, culls = dx.dense_cull_plain(cs.geom, cs.dense, o, d, limit)
    slab = torch.cat([c["group"] for c in culls], 1)
    assert not group[limit == 0].any()
    assert slab[limit > 0].float().mean() < 0.1
    assert (group | slab).equal(group) and group.float().mean() < 1.0


def test_cull_and_ties_on_constructed_scene(tmp_path):
    """A bumpy grid mesh with duplicate triangles, twice at one place and
    once moved, and a second mesh: rays aimed at their shared edges,
    vertices and box faces, and rays in the planes of box faces. Equal t arises across the
    two coincident instances (the first keeps its hit), between each
    duplicate pair (the lower id wins) and on shared edges; the
    leaf-order search under the kernel's tie rule equals the plain
    search bit for bit and the cull keeps every accepted pair."""
    cs = tie_scene(tmp_path)
    rng = np.random.default_rng(103)
    o, d = aimed_rays(cs, rng, 600)
    o2, d2 = face_plane_rays(cs, rng, 300)
    o3, d3 = flat_rays(rng, 200)
    o, d = np.concatenate([o, o2, o3]), np.concatenate([d, d2, d3])
    B = o.shape[0]  # check_cull's every 9th lane is dead
    want, _ = check_cull(cs, o, d)
    # equal t in both flat instances, a lower id in the second: the first
    # keeps its hit
    flat = want.inst[-200:][torch.arange(B - 200, B) % 9 != 4]
    assert (flat == FLAT_INSTANCES[0]).all()
    hit = want.inst >= 0
    assert hit.float().mean() > 0.3
    assert (want.inst == 3).any()  # the second mesh
    # the second of the two coincident instances never wins
    assert not (want.inst == 1).any() and (want.inst == 0).any()
    # a duplicate triangle never wins over its original
    assert not ((want.prim >= DUPLICATES[0][0])
                & (want.prim <= DUPLICATES[-1][0])).any()
    # rays straight down onto a duplicate's centroid: a tie of equal t
    # between the original and its copy, the original's id wins
    tri = cs.geom.tri_packed.double().numpy()
    for k, orig in DUPLICATES:
        v0, e1, e2 = tri[k, 0:3], tri[k, 3:6], tri[k, 6:9]
        c = world(cs, 0, (v0 + (v0 - e1) + (v0 + e2))[None] / 3)[0]
        oc = np.array([c + [0.0, 0.0, -3.0]], np.float32)
        dc = np.array([[0.0, 0.0, 1.0]], np.float32)
        h, _ = check_cull(cs, oc, dc, torch.full((1,), FLT_MAX))
        assert (int(h.inst[0]), int(h.prim[0])) == (0, orig)


def test_leaf_order_search_matches_plain_on_random_rays(scene):
    """Random rays (some dead) through the scene bounds: the leaf-order
    search equals dense_hit_plain bit for bit; every accepted pair is
    kept."""
    name, cs = scene
    rng = np.random.default_rng(104)
    B = 256
    bb = cs.geom.node_bounds[0].numpy()
    lo, hi = bb[[0, 2, 4]], bb[[1, 3, 5]]
    o = rng.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo),
                    (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    check_cull(cs, o, d)


def test_box_factor_bounds_the_shapes(scene):
    """Every box's margin factor F (its eighth float) is at least 1 and
    at least RHO / (THETA * mu) for each of its triangles, mu = |n| / L^2
    computed here from the vertices (L the largest |component| of the
    three edges), and no more than an ulp above the largest of these; a
    box F = 1 holds no triangle of mu < RHO / THETA."""
    name, cs = scene
    dn = cs.dense
    tri = cs.geom.tri_packed.double().numpy()
    checked = 0
    for m, (base, n) in enumerate(dx.mesh_rows(cs.geom)):
        if n == 0:
            continue
        t = tri[dn.leaf_ids[base:base + n].long().numpy()]
        v = [t[:, 0:3], t[:, 0:3] - t[:, 3:6], t[:, 0:3] + t[:, 6:9]]
        L = np.stack([np.abs(v[a] - v[b]).max(1)
                      for a, b in ((1, 0), (2, 0), (2, 1))]).max(0)
        mu = np.linalg.norm(np.cross(v[1] - v[0], v[2] - v[0]), axis=1) / L**2
        need = np.maximum(1.0, dx.RHO / (dx.THETA * mu))
        sb0, g0 = dn.mesh_index[m].tolist()
        for size, boxes, first in ((dx.GROUP, dn.group_box, g0),
                                   (dx.TILE, dn.block_box, sb0),
                                   (n, dn.root_box, m)):
            k = -(-n // size)
            F = boxes[first:first + k, 7].double().numpy()
            want = np.maximum.reduceat(need, np.arange(0, n, size))
            assert (F >= want).all(), name
            assert (F <= want * (1 + 2.0 ** -22)).all(), name
            checked += k
    assert checked > 0
    # the highpoly sphere's pole slivers get wide margins, the rest F = 1
    if name == "stress_highpoly":
        F = dn.group_box[:, 7]
        assert float(F.max()) > 8.0 and float((F == 1.0).float().mean()) > 0.3


@pytest.mark.parametrize("where", ["poles", "silhouette", "near_plane"])
def test_cull_keeps_every_accepted_pair_on_tangent_rays(highpoly, where):
    """stress_highpoly's grazing rays: tangent to the sphere through
    points of its pole triangles (slivers, whose boxes carry F > 1), along
    its silhouette from viewpoints 2.5-4 radii away, and through slivers
    at THETA to 4 THETA off their plane: no pair that the plain test
    accepts at or below the final best is culled, and the leaf-order
    search equals the plain one bit for bit."""
    rng = np.random.default_rng({"poles": 105, "silhouette": 106,
                                 "near_plane": 107}[where])
    if where == "near_plane":
        o, d = near_plane_rays(highpoly, rng, 160, dx.THETA, 4 * dx.THETA)
    else:
        o, d = tangent_rays(highpoly, rng, 160, where)
    want, accepted = check_cull(highpoly, o, d)
    assert (want.prim >= 0).float().mean() > 0.3
    assert accepted > 100
