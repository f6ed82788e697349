"""Ray sets and a tie scene for K3's cull (tests/test_torch_dense_cull.py
on the CPU, tests/test_torch_kernels.py on the card): rays aimed from a
seed at triangle edges, vertices and group-box faces, rays that run in a
box face's plane, and a grid mesh with duplicate triangles placed twice
at one spot. This module imports neither jax nor craytpu."""

from __future__ import annotations

import json

import numpy as np

from craytpu_torch.ops import dense_isect as dx
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.scene.device import INST_MESH
from craytpu_torch.scene.sceneloader import load_scene_from_buf

# the tie scene's duplicate triangles: (copy id, original id); the first
# mesh's ids end after them
DUPLICATES = ((72, 3), (73, 17), (74, 40))


def grid_obj(path, n=6, dup=tuple(k for _, k in DUPLICATES)):
    """An n x n grid of quads over [-1, 1]^2 (z a bumpy height), two
    triangles a quad, and copies of the triangles `dup` appended (equal
    coefficients, higher ids)."""
    rng = np.random.default_rng(5)
    xs = np.linspace(-1.0, 1.0, n + 1)
    z = rng.uniform(-0.05, 0.05, (n + 1, n + 1))
    lines = [f"v {x:.6f} {y:.6f} {z[i, j]:.6f}"
             for i, y in enumerate(xs) for j, x in enumerate(xs)]
    faces = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j + 1
            b, c, d = a + 1, a + n + 1, a + n + 2
            faces += [(a, b, d), (a, d, c)]
    faces += [faces[k] for k in dup]
    lines += [f"f {a} {b} {c}" for a, b, c in faces]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def flat_obj(path, n=4):
    """An n x n grid of unit quads at z = 0 with integer vertices (every
    triangle's coefficients exact), ids increasing with x then y."""
    lines = [f"v {x} {y} 0" for y in range(n + 1) for x in range(n + 1)]
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j + 1
            b, c, d = a + 1, a + n + 1, a + n + 2
            lines += [f"f {a} {b} {d}", f"f {a} {d} {c}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# the tilted floor's plane normal (floor_obj)
FLOOR_NORMAL = (0.3, 0.5, 0.81)


def floor_basis():
    """(unit normal, two unit in-plane axes) of the tilted floor."""
    nh = np.asarray(FLOOR_NORMAL) / np.linalg.norm(FLOOR_NORMAL)
    u = np.cross(nh, [0.0, 0.0, 1.0])
    u /= np.linalg.norm(u)
    return nh, u, np.cross(nh, u)


def floor_obj(path, n=24, size=1.0, center=(0.0, 0.0, 0.0), seed=7):
    """An n x n grid of jittered quads, two triangles a quad, over
    [-size, size]^2 of the plane through `center` with normal
    FLOOR_NORMAL: its vertices lie on no float grid, so each triangle's
    coefficients are rounded and its own plane is the floor's within
    rounding."""
    rng = np.random.default_rng(seed)
    _, u, w = floor_basis()
    g = np.linspace(-1.0, 1.0, n + 1)
    pts = [np.asarray(center) + size * ((x + jx) * u + (y + jy) * w)
           for y in g for x in g
           for jx, jy in [rng.uniform(-0.3, 0.3, 2) * (2.0 / n)]]
    lines = [f"v {q[0]:.9g} {q[1]:.9g} {q[2]:.9g}" for q in pts]
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j + 1
            b, c, d = a + 1, a + n + 1, a + n + 2
            lines += [f"f {a} {b} {d}", f"f {a} {d} {c}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def floor_scene(tmp_path, device="cpu", **kw):
    """The tilted floor (floor_obj's keywords) as the only mesh of a
    scene, its instance the identity."""
    floor_obj(tmp_path / "floor.obj", **kw)
    scene = {
        "version": 1.0,
        "renderer": {"samples": 1, "bounces": 2, "tileWidth": 16,
                     "tileHeight": 16, "outputFilePath": "output/",
                     "outputFileName": "floor", "width": 32, "height": 24},
        "camera": {"FOV": 60.0, "transforms": [
            {"type": "translate", "x": 0.0, "y": 0.0, "z": -4.0}]},
        "scene": {"ambientColor": {"down": {"r": 0.8, "g": 0.8, "b": 0.8},
                                   "up": {"r": 0.4, "g": 0.6, "b": 0.9}},
                  "primitives": [],
                  "meshes": [{"fileName": "floor.obj", "bsdf": "lambertian",
                              "instances": [{"transforms": [
                                  {"type": "translate", "x": 0.0, "y": 0.0,
                                   "z": 0.0}]}]}]}}
    return compile_scene(load_scene_from_buf(json.dumps(scene),
                                             str(tmp_path) + "/"), device)


# the tie scene's flat grid: its two instances (the second moved one cell
# along +x, so that a point of both has a lower id in the second), the
# first one's x offset (clear of the other meshes) and its plane's z
FLAT_INSTANCES, FLAT_X, FLAT_Z = (4, 5), 8.0, 3.0


def flat_rays(rng, B):
    """B rays along +z onto the tie scene's flat grid where both of its
    instances cover it: every hit is a tie of equal t across the two."""
    o = np.zeros((B, 3), np.float32)
    o[:, 0] = rng.uniform(FLAT_X + 1.1, FLAT_X + 3.9, B)
    o[:, 1] = rng.uniform(-1.9, 1.9, B)
    o[:, 2] = FLAT_Z - 4.0
    d = np.zeros((B, 3), np.float32)
    d[:, 2] = 1.0
    return o, d


def tie_scene(tmp_path, device="cpu"):
    """The grid mesh twice at the same place (equal t in two instances of
    one mesh) and once turned and moved; a second mesh (a 5 x 5 grid, its
    ids after the first's, its groups and superblocks after the first's
    in the layout) once, turned the other way and moved; a flat integer
    grid twice, one cell apart (`flat_rays` meet both at equal t)."""
    grid_obj(tmp_path / "grid.obj")
    grid_obj(tmp_path / "grid5.obj", n=5, dup=())
    flat_obj(tmp_path / "flat.obj")
    flat = [{"transforms": [{"type": "translate", "x": x, "y": -2.0,
                             "z": FLAT_Z}]} for x in (FLAT_X, FLAT_X + 1)]
    same = {"transforms": [{"type": "translate", "x": 0.0, "y": 0.0,
                            "z": 0.5}]}
    scene = {
        "version": 1.0,
        "renderer": {"samples": 1, "bounces": 2, "tileWidth": 16,
                     "tileHeight": 16, "outputFilePath": "output/",
                     "outputFileName": "ties", "width": 32, "height": 24},
        "camera": {"FOV": 60.0, "transforms": [
            {"type": "translate", "x": 0.0, "y": 0.0, "z": -4.0}]},
        "scene": {"ambientColor": {"down": {"r": 0.8, "g": 0.8, "b": 0.8},
                                   "up": {"r": 0.4, "g": 0.6, "b": 0.9}},
                  "primitives": [],
                  "meshes": [{"fileName": "grid.obj", "bsdf": "lambertian",
                              "instances": [same, same, {"transforms": [
                                  {"type": "rotateY", "degrees": 30},
                                  {"type": "translate", "x": 0.3,
                                   "y": 0.2, "z": 1.5}]}]},
                             {"fileName": "grid5.obj", "bsdf": "lambertian",
                              "instances": [{"transforms": [
                                  {"type": "rotateY", "degrees": -40},
                                  {"type": "translate", "x": -0.4,
                                   "y": -0.3, "z": 2.5}]}]},
                             {"fileName": "flat.obj", "bsdf": "lambertian",
                              "instances": flat}]}}
    return compile_scene(load_scene_from_buf(json.dumps(scene),
                                             str(tmp_path) + "/"), device)


def world(cs, i, p):
    """Mesh-space points p (n, 3) of instance i in world space."""
    A = cs.geom.inst_A[i].double().numpy()
    return p @ A[:, :3].T + A[:, 3]


def aimed_rays(cs, rng, B):
    """B rays from around the scene aimed at points of its meshes' mesh
    instances: a third at triangle edges, a third at vertices, a third at
    points of group-box faces; (o, d) float32."""
    g = cs.geom
    tri = g.tri_packed.double().numpy()
    gbox = cs.dense.group_box.double().numpy()
    plan = cs.dense.plan.numpy()
    index = cs.dense.mesh_index.numpy()
    inst = [i for i, p in enumerate(plan) if p[0] == INST_MESH and p[2]]
    bb = g.node_bounds[0].double().numpy()
    lo, hi = bb[[0, 2, 4]], bb[[1, 3, 5]]
    o = rng.uniform(lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo), (B, 3))
    targets = np.zeros((B, 3))
    kind = np.arange(B) % 3
    for r in range(B):
        i = inst[rng.integers(len(inst))]
        _, first, n, obj = plan[i]
        k = first + rng.integers(n)
        v0, e1, e2 = tri[k, 0:3], tri[k, 3:6], tri[k, 6:9]
        verts = (v0, v0 - e1, v0 + e2)
        if kind[r] == 0:                       # an edge
            a = rng.integers(3)
            s = rng.uniform()
            p = verts[a] + s * (verts[(a + 1) % 3] - verts[a])
        elif kind[r] == 1:                     # a vertex
            p = verts[rng.integers(3)]
        else:                                  # a face of a group box
            gb = gbox[index[obj][1] + rng.integers(-(-n // dx.GROUP))]
            blo, bhi = gb[0:3], gb[4:7]
            p = rng.uniform(blo, bhi)
            ax = rng.integers(3)
            p[ax] = (blo if rng.integers(2) else bhi)[ax]
        targets[r] = world(cs, i, p[None])[0]
    d = targets - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def face_plane_rays(cs, rng, B):
    """B rays that run in the plane of a group box's face: origin on the
    face's plane, direction with an exact zero across it (the slab test's
    d_i = 0 case); the mesh instance's transform must keep axes (the grid
    scene's first instance, a translation)."""
    gbox = cs.dense.group_box.double().numpy()
    A = cs.geom.inst_A[0].double().numpy()
    o = np.zeros((B, 3))
    d = rng.normal(size=(B, 3))
    for r in range(B):
        gb = gbox[rng.integers(gbox.shape[0])]
        ax = rng.integers(3)
        p = rng.uniform(gb[0:3] - 0.5, gb[4:7] + 0.5)
        p[ax] = gb[4 * rng.integers(2) + ax]
        o[r] = p @ A[:, :3].T + A[:, 3]
        d[r, ax] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _mesh_instance(cs):
    """(instance, first row, rows) of the scene's first mesh instance."""
    for i, (kind, first, n, _) in enumerate(cs.dense.plan.tolist()):
        if kind == INST_MESH and n:
            return i, first, n
    raise ValueError("the scene has no mesh instance")


def _to_world(cs, i, p, d):
    """Mesh-space points p and directions d (n, 3) of instance i as world
    rays (o, d) float32, d unit."""
    A = cs.geom.inst_A[i].double().numpy()
    o = world(cs, i, p)
    return o.astype(np.float32), _unit(d @ A[:, :3].T).astype(np.float32)


def tangent_rays(cs, rng, B, where):
    """B rays that graze the stress_highpoly sphere (a UV sphere about
    the mesh-space origin, poles on y), through points of its triangles:
    `where` "poles", tangent to the sphere through a point of a
    triangle within about 14 degrees of a pole (where the triangles are
    slivers), in a random tangent direction; "silhouette", from a
    viewpoint 2.5-4 radii away through a point of a triangle on the
    sphere's silhouette seen from there (the ray tangent to the sphere
    to within 3 degrees)."""
    i, first, n = _mesh_instance(cs)
    tri = cs.geom.tri_packed.double().numpy()[first:first + n]
    v0 = tri[:, 0:3]
    cen = (3 * v0 - tri[:, 3:6] + tri[:, 6:9]) / 3
    rad = np.linalg.norm(cen, axis=1).mean()
    p, d = np.zeros((B, 3)), np.zeros((B, 3))
    if where == "poles":
        pick = np.nonzero(np.abs(cen[:, 1]) / np.linalg.norm(cen, axis=1)
                          > np.cos(np.radians(14)))[0]
    for r in range(B):
        if where == "poles":
            k = pick[rng.integers(pick.size)]
            a, b = rng.dirichlet(np.ones(3))[:2]
            q = v0[k] - a * tri[k, 3:6] + b * tri[k, 6:9]
            t = rng.normal(size=3)
            t -= (t @ q) * q / (q @ q)
            d[r] = _unit(t)
            p[r] = q - 3.0 * rad * d[r]
            continue
        while True:
            eye = _unit(rng.normal(size=3)) * rad * rng.uniform(2.5, 4.0)
            to = cen - eye
            cos = np.abs(np.einsum("ij,ij->i", _unit(cen), _unit(to)))
            pick = np.nonzero(cos < np.sin(np.radians(3)))[0]
            if pick.size:
                break
        k = pick[rng.integers(pick.size)]
        d[r] = _unit(to[k])
        p[r] = eye
    return _to_world(cs, i, p, d)


def near_plane_rays(cs, rng, B, lo, hi, share=0.02):
    """B rays through a point of one of the `share` of the mesh's
    triangles with the least shape |n| / L^2 (slivers), at an angle
    between lo and hi radians to its plane; the mesh instance must keep
    angles (a rotation, a uniform scale, a move)."""
    i, first, n = _mesh_instance(cs)
    tri = cs.geom.tri_packed.double().numpy()[first:first + n]
    mu = dx.tri_shape(tri)
    pick = np.argsort(mu)[:max(int(share * n), 1)]
    p, d = np.zeros((B, 3)), np.zeros((B, 3))
    for r in range(B):
        k = pick[rng.integers(pick.size)]
        v0, e1, e2 = tri[k, 0:3], tri[k, 3:6], tri[k, 6:9]
        nh = _unit(np.cross(-e1, e2))
        a = rng.normal(size=3)
        a = _unit(a - (a @ nh) * nh)
        beta = rng.uniform(lo, hi) * rng.choice([-1.0, 1.0])
        d[r] = np.cos(beta) * a + np.sin(beta) * nh
        u, v = rng.dirichlet(np.ones(3))[:2]
        q = v0 - u * e1 + v * e2
        p[r] = q - rng.uniform(0.2, 3.0) * d[r]
    return _to_world(cs, i, p, d)


# the angles (radians) off a triangle's plane that graze_rays cycles
# through; every sixth ray takes one uniform in [0, THETA) instead
GRAZE_ANGLES = (0.0, 1e-8, 1e-6, 1e-4, 1e-3)


def graze_rays(cs, rng, B, where, dist, share=1.0):
    """B rays off the plane of one of the `share` of the first mesh
    instance's triangles with the least shape |n| / L^2 (1.0: any), at
    the angles GRAZE_ANGLES and up to THETA (0: in the plane, built in
    float64, then rounded): `where` "through", through a point of the
    triangle in a random direction of its plane, tilted by the angle;
    "beside", through a point of its plane outside its group's box (one
    to two box diagonals from its centroid), along the plane
    perpendicular to that offset (so the line keeps off the box), tilted
    by the angle; from an origin dist = (lo, hi) units back along the
    ray. The mesh instance must keep angles."""
    i, first, n = _mesh_instance(cs)
    tri = cs.geom.tri_packed.double().numpy()[first:first + n]
    mu = dx.tri_shape(tri)
    pick = np.argsort(mu)[:max(int(share * n), 1)]
    rows = np.argsort(cs.dense.leaf_ids[first:first + n].numpy() - first)
    g0 = int(cs.dense.mesh_index[cs.dense.plan[i, 3]][1])
    gbox = cs.dense.group_box.double().numpy()
    p, d = np.zeros((B, 3)), np.zeros((B, 3))
    for r in range(B):
        k = pick[rng.integers(pick.size)]
        v0, e1, e2 = tri[k, 0:3], tri[k, 3:6], tri[k, 6:9]
        nh = _unit(np.cross(-e1, e2))
        a = rng.normal(size=3)
        a = _unit(a - (a @ nh) * nh)
        if where == "through":
            u, v = rng.dirichlet(np.ones(3))[:2]
            q = v0 - u * e1 + v * e2
        else:
            gb = gbox[g0 + rows[k] // dx.GROUP]
            diag = np.linalg.norm(gb[4:7] - gb[0:3])
            q = v0 + (e2 - e1) / 3 + rng.uniform(1.0, 2.0) * diag * a
            a = _unit(np.cross(nh, a))
        k_ang = r % (len(GRAZE_ANGLES) + 1)
        beta = (GRAZE_ANGLES[k_ang] if k_ang < len(GRAZE_ANGLES)
                else rng.uniform(0.0, dx.THETA)) * rng.choice([-1.0, 1.0])
        d[r] = np.cos(beta) * a + np.sin(beta) * nh
        p[r] = q - rng.uniform(*dist) * d[r]
    return _to_world(cs, i, p, d)


def floor_edge_rays(rng, B, dist):
    """B rays in the tilted floor's plane (angles GRAZE_ANGLES[:2]: 0,
    built in float64, and 1e-8), along its u axis at 1.1-1.4 of its
    half-width beside it on w."""
    nh, u, w = floor_basis()
    o, d = np.zeros((B, 3)), np.zeros((B, 3))
    for r in range(B):
        q = rng.uniform(-1.0, 1.0) * u + rng.choice([-1.0, 1.0]) \
            * rng.uniform(1.1, 1.4) * w
        beta = GRAZE_ANGLES[r % 2] * rng.choice([-1.0, 1.0])
        d[r] = np.cos(beta) * u * rng.choice([-1.0, 1.0]) + np.sin(beta) * nh
        o[r] = q - rng.uniform(*dist) * d[r]
    return o.astype(np.float32), d.astype(np.float32)
