"""Dense closest hit (CRAYTPU_TRAVERSAL=dense): every ray against every
triangle of every instance, with no BVH. The K3 kernel and its plain
version; the port of craytpu/ops/dense_isect.py.

With triangle data (v0, e1 = v0 - v1, e2 = v2 - v0, n = e1 x e2) and a
ray (o, d), every Möller–Trumbore quantity is bilinear in the ray
features phi = [d, o, w = d x o, 1]:

    det   = d.n
    u*det = d.(v0 x e2) + w.(-e2)
    v*det = d.(v0 x e1) + w.(-e1)
    t*det = o.(-n) + n.v0

The JAX package evaluates these as one matmul per 256-triangle block
(`build_tri_coeffs`). The port keeps the nonzero coefficients of each
triangle as one 16-float row (`build_tri_table`) and sums the products
explicitly, in the feature order of phi, in both the plain version and
the kernel, so the two agree bit for bit. The search only has to pick the
winner: K1 recomputes the winner's (t, u, v) exactly with the walk's
triangle test (ops/hitrec.py::Isect).

Order and tie rules (the contract `dense_hit_plain` and csrc/dense_hit.cu
share): instances in index order, the running best carried across them
in each instance's own t measure; a mesh's triangles in row order with a
strict t < best (the lowest triangle index among equal t, as the JAX
package's argmin per block and strict < across blocks); a sphere by the
exact quadratic with t >= 1e-5 and t <= best, as the walk tests it. The
instance-space ray is the walk's (`traverse.object_ray`), not the JAX
package's einsum. The best distance starts at the ray's limit; a lane
whose limit is not > 0 (a dead lane) misses.

`dense_hit` is the dispatching wrapper: tensors on the CPU go to the
plain version, CUDA tensors to the hand-written kernel
(csrc/dense_hit.cu).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from craytpu_torch.ops import cuda_build
from craytpu_torch.ops import intersect as isx
from craytpu_torch.ops import traverse as trv
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.scene.device import Geometry, Hit, INST_MESH, INST_SPHERE

FLT_MAX = isx.FLT_MAX
# triangles per coefficient block of the JAX package's layout
TRI_BLOCK = 256
# the plain version's (rays x triangles) elements per chunk
PLAIN_CHUNK_ELEMS = 1 << 18


def _tri_terms(tri_packed: np.ndarray) -> tuple:
    """The nonzero coefficients of each triangle of (P, 12) packed
    triangles, by the JAX package's numpy expressions in its order
    (craytpu/ops/dense_isect.py::build_tri_coeffs): n, v0 x e2, -e2,
    v0 x e1, -e1 (each (P, 3)) and n.v0 (P,)."""
    tri = np.asarray(tri_packed, np.float32)
    v0, e1, e2, n = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], tri[:, 9:12]
    return (n, np.cross(v0, e2), -e2, np.cross(v0, e1), -e1,
            np.einsum("ij,ij->i", n, v0))


def build_tri_coeffs(tri_packed: np.ndarray) -> np.ndarray:
    """(P, 12) packed triangles -> (nblocks, 10, 4*TRI_BLOCK) coefficients,
    the JAX package's layout, bit for bit.

    Within a block the columns are [det | u*det | v*det | t*det], each a
    TRI_BLOCK-wide group. Padded slots are all-zero."""
    n, c_u, w_u, c_v, w_v, nv0 = _tri_terms(tri_packed)
    P = n.shape[0]
    nb = max((P + TRI_BLOCK - 1) // TRI_BLOCK, 1)
    W = np.zeros((nb * TRI_BLOCK, 4, 10), np.float32)
    W[:P, 0, 0:3] = n                     # det = d.n
    W[:P, 1, 0:3] = c_u                   # u*det: d term
    W[:P, 1, 6:9] = w_u                   # u*det: w term
    W[:P, 2, 0:3] = c_v                   # v*det: d term
    W[:P, 2, 6:9] = w_v                   # v*det: w term
    W[:P, 3, 3:6] = -n                    # t*det: o term
    W[:P, 3, 9] = nv0                     # t*det: const term
    # (nb, TB, 4, 10) -> (nb, 10, 4, TB) -> (nb, 10, 4*TB)
    Wb = W.reshape(nb, TRI_BLOCK, 4, 10).transpose(0, 3, 2, 1)
    return np.ascontiguousarray(Wb.reshape(nb, 10, 4 * TRI_BLOCK))


def build_tri_table(tri_packed: np.ndarray) -> np.ndarray:
    """(P, 12) packed triangles -> (P, 16) rows of the nonzero entries of
    `build_tri_coeffs`: [n, v0 x e2, -e2, v0 x e1, -e1, n.v0]. The t*det
    row's o term, -n, is the negated n of columns 0:3 (exact). 64 bytes a
    triangle: four 16-byte loads in the kernel."""
    *vecs, nv0 = _tri_terms(tri_packed)
    return np.ascontiguousarray(
        np.concatenate([*vecs, nv0[:, None]], axis=1), dtype=np.float32)


@dataclass
class DenseLayout:
    """The dense search's copy of the scene (`CompiledScene.dense`).

      table (P, 16) f32: build_tri_table of tri_packed, row = triangle id.
      plan (I, 4) i32: per instance, in search (index) order: [kind,
        first row, rows, object]; rows is 0 for an instance the search
        skips (a mesh without triangles).
    """
    table: torch.Tensor
    plan: torch.Tensor


def mesh_rows(geom: Geometry) -> list:
    """(first triangle id, triangle count) of each mesh, (0, 0) for a mesh
    without a BVH, read from the flattened BVH alone: mesh m's BLAS nodes
    run from blas_root[m] to the next root, and its leaves' slots hold
    its triangle ids, base + a permutation of range(count)."""
    root = geom.blas_root.cpu().numpy()
    child = geom.node_child.cpu().numpy()
    count = geom.node_count.cpu().numpy()
    prim = geom.prim_idx.cpu().numpy()
    starts = sorted(int(r) for r in root if r >= 0) + [child.shape[0]]
    out = []
    for r in root:
        if r < 0:
            out.append((0, 0))
            continue
        end = starts[starts.index(int(r)) + 1]
        leaf = count[r:end] > 0
        lo = int(child[r:end][leaf].min())
        hi = int((child[r:end] + count[r:end])[leaf].max())
        ids = prim[lo:hi]
        base, n = int(ids.min()), hi - lo
        if int(ids.max()) != base + n - 1:
            raise ValueError(f"mesh BVH at node {r}: its leaves do not hold "
                             "one contiguous range of triangles")
        out.append((base, n))
    return out


def build_dense(geom: Geometry, n_instances: int) -> DenseLayout:
    """The dense search's tables, on the device of `geom`."""
    table = build_tri_table(geom.tri_packed.detach().cpu().numpy())
    rows = mesh_rows(geom)
    kind = geom.inst_kind.cpu().numpy()
    obj = geom.inst_obj.cpu().numpy()
    plan = np.zeros((n_instances, 4), np.int32)
    for i in range(n_instances):
        k, o = int(kind[i]), int(obj[i])
        first, n = rows[o] if k == INST_MESH else (0, 0)
        plan[i] = (k, first, n, o)
    dev = geom.tri_packed.device
    return DenseLayout(table=torch.from_numpy(table).to(dev),
                       plan=torch.from_numpy(plan).to(dev))


def _block_min(rows, o, d, w, best_t):
    """Closest valid triangle of `rows` (C, 16) for each ray: (t, j), t
    +inf where none is valid (t < best_t among them), j the lowest row
    index of the minimum. Each quantity is the explicit sum of its
    products in phi's feature order, two roundings a term."""
    def col(k):
        return rows[:, k][None, :]

    def ray(x, k):
        return x[:, k][:, None]

    det = ray(d, 0) * col(0) + ray(d, 1) * col(1) + ray(d, 2) * col(2)
    ud = (ray(d, 0) * col(3) + ray(d, 1) * col(4) + ray(d, 2) * col(5)
          + ray(w, 0) * col(6) + ray(w, 1) * col(7) + ray(w, 2) * col(8))
    vd = (ray(d, 0) * col(9) + ray(d, 1) * col(10) + ray(d, 2) * col(11)
          + ray(w, 0) * col(12) + ray(w, 1) * col(13) + ray(w, 2) * col(14))
    td = (ray(o, 0) * -col(0) + ray(o, 1) * -col(1) + ray(o, 2) * -col(2)
          + col(15))
    inv = torch.ones_like(det) / det  # a tensor division: correctly rounded
    u, v, t = ud * inv, vd * inv, td * inv
    valid = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
             & (t < best_t[:, None]))
    t = torch.where(valid, t, float("inf"))
    j = torch.argmin(t, dim=1)
    return t.gather(1, j[:, None])[:, 0], j


def dense_hit_plain(geom: Geometry, dense: DenseLayout, o_w, d_w,
                    limit) -> Hit:
    """The plain version of K3: each instance in order over all rays; a
    mesh in chunks of whole TRI_BLOCKs of about PLAIN_CHUNK_ELEMS
    (ray, triangle) pairs (a chunk's minimum, then a strict < against
    the running best, picks what a triangle-by-triangle loop picks)."""
    B = o_w.shape[0]
    dev = o_w.device
    best_t = limit.clone()
    best_prim = torch.full((B,), -1, dtype=torch.int64, device=dev)
    best_inst = torch.full((B,), -1, dtype=torch.int64, device=dev)
    chunk = max(PLAIN_CHUNK_ELEMS // max(B, 1) // TRI_BLOCK, 1) * TRI_BLOCK
    for i, (kind, first, n, obj) in enumerate(dense.plan.tolist()):
        if kind != INST_SPHERE and n == 0:
            continue
        o, d = trv.object_ray(geom.inst_Ainv[i], geom.inst_offset[i], o_w,
                              d_w)
        if kind == INST_SPHERE:
            hit, t = isx.sphere_intersect(geom.sph_radius[obj], o, d, best_t)
            best_t = torch.where(hit, t, best_t)
            best_prim = torch.where(hit, -1, best_prim)
            best_inst = torch.where(hit, i, best_inst)
            continue
        w = vm.vcross(d, o)
        for c in range(0, n, chunk):
            rows = dense.table[first + c:first + min(c + chunk, n)]
            t, j = _block_min(rows, o, d, w, best_t)
            upd = t < best_t
            best_t = torch.where(upd, t, best_t)
            best_prim = torch.where(upd, first + c + j, best_prim)
            best_inst = torch.where(upd, i, best_inst)
    dead = ~(limit > 0.0)
    return Hit(t=torch.where(dead, FLT_MAX, best_t),
               prim=torch.where(dead, -1, best_prim).to(torch.int32),
               inst=torch.where(dead, -1, best_inst).to(torch.int32))


def dense_hit(geom: Geometry, o_w, d_w, limit, dense: DenseLayout) -> Hit:
    """Closest hit of each ray (o_w, d_w (B, 3)) under its limit (B,) by
    the dense search. CPU tensors: the plain version. CUDA tensors: the
    K3 kernel, or an error. Returns Hit(t f32, prim i32 (-1 sphere), inst
    i32 (-1 miss)) with closest_hit's conventions; t is the search's own
    (K1 recomputes the winner's)."""
    if o_w.device.type == "cpu":
        return dense_hit_plain(geom, dense, o_w, d_w, limit)
    B = o_w.shape[0]
    P, I = dense.table.shape[0], dense.plan.shape[0]
    check = cuda_build.check_tensor
    check(o_w, "o_w", torch.float32, (B, 3))
    check(d_w, "d_w", torch.float32, (B, 3))
    check(limit, "limit", torch.float32, (B,))
    check(dense.table, "table", torch.float32, (P, 16), align=16)
    check(dense.plan, "plan", torch.int32, (I, 4), align=16)
    for name in ("inst_Ainv", "inst_offset", "sph_radius"):
        check(getattr(geom, name), name, torch.float32)
    dev = o_w.device
    t = torch.empty(B, dtype=torch.float32, device=dev)
    prim = torch.empty(B, dtype=torch.int32, device=dev)
    inst = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return Hit(t=t, prim=prim, inst=inst)
    fn = cuda_build.function("dense_hit", "craytpu_dense_hit",
                             "pppippi" + "p" * 7)
    cuda_build.launch(
        "dense_hit", fn, o_w.data_ptr(), d_w.data_ptr(), limit.data_ptr(),
        B, dense.table.data_ptr(), dense.plan.data_ptr(), I,
        geom.inst_Ainv.data_ptr(), geom.inst_offset.data_ptr(),
        geom.sph_radius.data_ptr(), t.data_ptr(), prim.data_ptr(),
        inst.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, size=B)
    dense_hit.launches += 1
    return Hit(t=t, prim=prim, inst=inst)


dense_hit.launches = 0
