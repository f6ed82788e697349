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

The function (`dense_hit_plain`, its definition): instances in index
order, the running best carried across them in each instance's own t
measure; a mesh's triangles in id order with a strict t < best (the
lowest triangle id among equal t, as the JAX package's argmin per block
and strict < across blocks); a sphere by the exact quadratic with t >=
1e-5 and t <= best, as the walk tests it. The instance-space ray is the
walk's (`traverse.object_ray`), not the JAX package's einsum. The best
distance starts at the ray's limit; a lane whose limit is not > 0 (a
dead lane) misses.

The kernel (csrc/dense_hit.cu) reads each mesh's rows in its BLAS leaf
order instead (`DenseLayout.leaf_table`, each row carrying its triangle
id in `leaf_ids`), in groups of GROUP rows and superblocks of SUPER
groups, each behind a mesh-space box, the whole mesh behind its root box;
it skips a box that the ray provably cannot use (`dense_cull_plain`
models that decision). Its tie contract, which gives the same result:
inside one mesh instance a pair wins on t < best, or on t == best when
the best is a triangle of this same instance with a higher id (the
lowest id among equal t, in any row order); across instances ties stay
strict (the earlier instance keeps its hit); spheres keep t <= best.

`dense_hit` is the dispatching wrapper: tensors on the CPU go to the
plain version, CUDA tensors to the hand-written kernel.
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


# The kernel's layout: rows a group (one warp's vote) and groups a
# superblock (one shared-memory tile); superblocks whose votes one pass
# of the kernel gathers (a bit each)
GROUP = 32
SUPER = 8
TILE = GROUP * SUPER
SB_CHUNK = 256
# boxes a call of the cull model's vectorised box test
VOTE_CHUNK = 256

# The cull's margins, derived in csrc/dense_hit.cu's header: an accepted
# pair whose |det| >= rho * A * L^2 (L the triangle's largest edge
# component, O and A the ray's largest |o_i| and |d_i|, V the box's
# largest |coordinate|) lies within K_BOX * U * (V + O) of its
# triangle's box and within t * K_REL * U + K_ABS * U * (V + O) / A of
# its own t along the ray, the K's taken at rho = RHO. Each box carries
# the factor BOX_F = max(1, RHO / (THETA * mu_min)) of its triangles
# (mu = |n| / L^2 their shapes) and the kernel scales the K's by it, so
# that they hold at rho = RHO / F.
U = 2.0 ** -24
RHO = 2.0 ** -6
THETA = 2.0 ** -5
K_BOX = 382 / RHO + 18
K_REL = 2.03 + 30.2 / RHO
K_ABS = 55 / RHO


def _f32_up(x: float) -> float:
    """The least float32 >= x, as a Python float."""
    f = np.float32(x)
    return float(f if float(f) >= x else np.nextafter(f, np.float32(np.inf)))


# what the kernel multiplies by, rounded up, with room for the rounding
# of the box test's own operations (see the kernel's header); MARGIN_REL
# is the relative t margin's excess over 1
MARGIN_BOX = _f32_up((K_BOX + 2) * U * 1.01)
MARGIN_REL = _f32_up((K_REL + 4) * U)
MARGIN_ABS = _f32_up(1.01 * K_ABS * U)
# a slab interval computed in round-to-nearest, widened: 16 ulp a side
# and FLT_MIN (below it, the products lose their relative bound)
WIDEN_DN = 1.0 - 2.0 ** -20
WIDEN_UP = 1.0 + 2.0 ** -20
FLT_MIN = 2.0 ** -126
# The plane test, for the pairs whose |det| < rho * A * L^2 (the kernel's
# header derives it): such a pair is accepted only if the moment M = (v0
# - o) x d of the ray's line about the triangle's vertex v0 lies within
# A * (K_T * L + C_W * (V + O) * F) of the line of its normal n; the box
# keeps a ray whose line may do that for a normal in its cone [c, S]
# (S >= max |n_k - c| of its triangles' unit normals n_k, their signs
# turned toward c, plus CONE_SLACK) at a vertex in the box, whose
# centre is (lo + hi) * 0.5 and whose points lie within K_R * L_B + E_V *
# V of it (L_B the box's largest extent). E_X * max |x_i| covers the
# roundings of x = centre - o and M, SLACK those of the test's sums.
K_T = _f32_up(2.0 * 3.0 ** 0.5 * THETA)
C_W = _f32_up(760 * U)
K_R = _f32_up(0.8661)
E_V = 2.0 ** -21
E_X = 2.0 ** -18
SLACK = 1.0 + 2.0 ** -16
CONE_SLACK = 2.0 ** -20

@dataclass
class DenseLayout:
    """The dense search's copy of the scene (`CompiledScene.dense`).

      plan (I, 4) i32: per instance, in search (index) order: [kind,
        first row, rows, object]; rows is 0 for an instance the search
        skips (a mesh without triangles). A mesh's rows are [first, first
        + rows) of both tables.
      leaf_table (P, 16) f32: build_tri_table's rows, each mesh's in its
        BLAS leaf order (`mesh_leaf_rows`) regrouped into superblocks and
        groups by their normals or their places (`leaf_groups`);
        leaf_ids (P,) i32 the triangle id of each (a permutation of
        range(P)).
      mesh_index (M, 2) i32: per mesh object, its first superblock and
        first group. A mesh's groups are GROUP consecutive rows of
        leaf_table from its first row (the last may be short), its
        superblocks SUPER consecutive groups.
      root_box (M, 12), block_box (S, 12), group_box (G, 12) f32:
        mesh-space boxes [lo (3), V, hi (3), F, c (3), S] of each mesh,
        superblock and group: the exact bounds of its triangles' vertices
        widened by an ulp, V the largest |coordinate| of the box, F its
        margin factor (`box_factor`), [c, S] the cone of its triangles'
        normals (`box_cone`).

    `table` is the plain version's copy, row = triangle id, made from
    leaf_table when it is read.
    """
    plan: torch.Tensor
    leaf_table: torch.Tensor
    leaf_ids: torch.Tensor
    mesh_index: torch.Tensor
    root_box: torch.Tensor
    block_box: torch.Tensor
    group_box: torch.Tensor

    @property
    def table(self) -> torch.Tensor:
        """(P, 16) f32: build_tri_table of tri_packed in file order."""
        t = torch.empty_like(self.leaf_table)
        t[self.leaf_ids.long()] = self.leaf_table
        return t


def mesh_leaf_rows(geom: Geometry) -> list:
    """(first triangle id, triangle count, ids in leaf order) of each mesh,
    (0, 0, None) for a mesh without a BVH, read from the flattened BVH
    alone: mesh m's BLAS nodes run from blas_root[m] to the next root, and
    its leaves' slots hold its triangle ids, base + a permutation of
    range(count), in leaf order."""
    root = geom.blas_root.cpu().numpy()
    child = geom.node_child.cpu().numpy()
    count = geom.node_count.cpu().numpy()
    prim = geom.prim_idx.cpu().numpy()
    starts = sorted(int(r) for r in root if r >= 0) + [child.shape[0]]
    out = []
    for r in root:
        if r < 0:
            out.append((0, 0, None))
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
        out.append((base, n, ids.astype(np.int32)))
    return out


def mesh_rows(geom: Geometry) -> list:
    """(first triangle id, triangle count) of each mesh, (0, 0) for a mesh
    without a BVH (`mesh_leaf_rows` without the order)."""
    return [(base, n) for base, n, _ in mesh_leaf_rows(geom)]


def tri_bounds(tri_packed: np.ndarray) -> tuple:
    """(lo, hi) (P, 3) of each packed triangle's vertices v0, v1 = v0 - e1,
    v2 = e2 + v0, as the JAX package's build_tri_coeffs_T computes them
    (craytpu/ops/dense_isect.py), then widened by one ulp outward so that
    they hold the exact vertices (v1 and v2 are rounded)."""
    tri = np.asarray(tri_packed, np.float32)
    v0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    v1 = v0 - e1
    v2 = e2 + v0
    lo = np.minimum(v0, np.minimum(v1, v2))
    hi = np.maximum(v0, np.maximum(v1, v2))
    return (np.nextafter(lo, np.float32(-np.inf)),
            np.nextafter(hi, np.float32(np.inf)))


def tri_shape(tri_packed: np.ndarray) -> np.ndarray:
    """mu = |n| / L^2 (P,) float64 of each packed triangle with its exact
    vertices v0, v0 - e1, v0 + e2: n = (v1 - v0) x (v2 - v0), L the
    largest |component| of its three edges; 0 for a degenerate one."""
    tri = np.asarray(tri_packed, np.float32).astype(np.float64)
    v0 = tri[:, 0:3]
    v1, v2 = v0 - tri[:, 3:6], v0 + tri[:, 6:9]
    L = np.max([np.abs(e).max(axis=1) for e in (v1 - v0, v2 - v0, v2 - v1)],
               axis=0)
    n = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(L > 0.0, n / (L * L), 0.0)


def tri_normals(tri_packed: np.ndarray) -> np.ndarray:
    """Unit normals (P, 3) float64 of the packed triangles with their
    exact vertices, e1 x e2 normalised (as tri_shape; NaN for a
    degenerate triangle). Each is within 2^-48 / mu of the exact unit
    normal, mu its shape."""
    tri = np.asarray(tri_packed, np.float32).astype(np.float64)
    n = np.cross(tri[:, 3:6], tri[:, 6:9])
    with np.errstate(divide="ignore", invalid="ignore"):
        return n / np.linalg.norm(n, axis=1, keepdims=True)


def _aligned(nh: np.ndarray) -> np.ndarray:
    """Unit normals (n, 3) with their signs turned toward the first's,
    then three times toward their mean."""
    v = nh * np.where(nh @ nh[0] < 0.0, -1.0, 1.0)[:, None]
    for _ in range(3):
        v = v * np.where(v @ v.sum(axis=0) < 0.0, -1.0, 1.0)[:, None]
    return v


def box_cone(nh: np.ndarray, mu_min: float) -> np.ndarray:
    """The normal cone [c (3), S] float32 of the unit normals nh (n, 3) of
    triangles of least shape mu_min: c the float32 mean of the normals
    with their signs turned toward the first's, S >= max |n_k - c / |c||
    + 2^-48 / mu_min (tri_normals' error) + CONE_SLACK, rounded up;
    [0, 0, 1, 4] (no cone: the plane test keeps the box) where a normal
    is NaN."""
    if not (np.isfinite(nh).all() and mu_min > 0.0):
        return np.array([0.0, 0.0, 1.0, 4.0], np.float32)
    sh = _aligned(nh)
    m = sh.sum(axis=0)
    if not np.linalg.norm(m) > 0.0:
        return np.array([0.0, 0.0, 1.0, 4.0], np.float32)
    c = (m / np.linalg.norm(m)).astype(np.float32)
    ch = c.astype(np.float64) / np.linalg.norm(c.astype(np.float64))
    spread = np.linalg.norm(sh - ch, axis=1).max()
    return np.append(c, _f32_up((spread + 2.0 ** -48 / mu_min)
                                * (1.0 + 2.0 ** -40)
                                + CONE_SLACK)).astype(np.float32)


def _axis(x: np.ndarray) -> np.ndarray:
    """The principal axis of the rows of x (n, 3) about their mean, its
    largest component positive."""
    ax = np.linalg.svd(x - x.mean(axis=0), full_matrices=False)[2][0]
    return ax * np.sign(ax[np.argmax(np.abs(ax))])


def plane_groups(nh: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                 scale: float, levels: int) -> np.ndarray:
    """A permutation of n = 2^levels * k rows (unit normals nh (n, 3),
    bounds lo, hi (n, 3)) into 2^levels runs of k: the rows split in
    halves at the median of their normals' principal axis or of their
    centres', whichever gives the halves the smaller sum of spread *
    scale + extent (the spread of their normals, up to sign; their
    boxes' largest extent), the halves again, `levels` times (stable
    sorts; the identity where a normal is NaN). The plane test keeps a
    box for a line within about spread * (the line's distance) + extent
    of it (csrc/dense_hit.cu's header), `scale` standing for that
    distance: a displaced mesh's groups gather by normal, a flat one's
    stay together in space."""
    idx = np.arange(nh.shape[0])
    if levels == 0 or not np.isfinite(nh).all():
        return idx
    v = _aligned(nh)
    cen = (lo + hi) * 0.5

    def cost(part):
        w = _aligned(nh[part])
        m = w.sum(axis=0)
        spread = np.linalg.norm(w - m / np.linalg.norm(m), axis=1).max()
        return spread * scale + (hi[part].max(axis=0)
                                 - lo[part].min(axis=0)).max()
    h = idx.size // 2
    splits = [np.argsort(x @ _axis(x), kind="stable") for x in (cen, v)]
    s = min(splits, key=lambda s: cost(s[:h]) + cost(s[h:]))
    return np.concatenate([
        s[:h][plane_groups(nh[s[:h]], lo[s[:h]], hi[s[:h]], scale,
                           levels - 1)],
        s[h:][plane_groups(nh[s[h:]], lo[s[h:]], hi[s[h:]], scale,
                           levels - 1)]])


def leaf_groups(order: np.ndarray, nh: np.ndarray, lo: np.ndarray,
                hi: np.ndarray) -> np.ndarray:
    """A mesh's row order from its BLAS leaf order `order` (triangle ids)
    and its triangles' unit normals and bounds (indexed by id): each
    whole run of SUPER superblocks re-split into superblocks, then each
    whole superblock into groups, by plane_groups (the mesh's box
    diagonal as its scale)."""
    order = order.copy()
    scale = float(np.linalg.norm(hi[order].max(axis=0)
                                 - lo[order].min(axis=0)))
    levels = SUPER.bit_length() - 1
    for size in (TILE * SUPER, TILE):
        for a in range(0, order.size - size + 1, size):
            run = order[a:a + size]
            order[a:a + size] = run[plane_groups(nh[run], lo[run], hi[run],
                                                 scale, levels)]
    return order


def box_factor(mu_min: np.ndarray) -> np.ndarray:
    """The margin factor F of boxes whose least triangle shape is mu_min:
    max(1, RHO / (THETA * mu_min)), rounded up (with room for the float64
    rounding of mu) to float32; +inf for a box holding a degenerate
    triangle (the kernel then always keeps it)."""
    with np.errstate(divide="ignore"):
        f = np.maximum(1.0, RHO / (THETA * mu_min) * (1.0 + 2.0 ** -30))
    f32 = f.astype(np.float32)
    return np.where(f32.astype(np.float64) < f,
                    np.nextafter(f32, np.float32(np.inf)), f32)


def _boxes(lo: np.ndarray, hi: np.ndarray, mu: np.ndarray, nh: np.ndarray,
           size: int) -> np.ndarray:
    """(ceil(n / size), 12) boxes [lo, V, hi, F, c, S] of consecutive runs
    of `size` rows of per-row bounds (n, 3), shapes mu (n,) and unit
    normals nh (n, 3)."""
    at = np.arange(0, lo.shape[0], size)
    blo = np.minimum.reduceat(lo, at, axis=0)
    bhi = np.maximum.reduceat(hi, at, axis=0)
    V = np.maximum(np.abs(blo), np.abs(bhi)).max(axis=1, keepdims=True)
    F = box_factor(np.minimum.reduceat(mu, at))[:, None]
    cone = np.stack([box_cone(nh[a:a + size], mu[a:a + size].min())
                     for a in at])
    return np.concatenate([blo, V, bhi, F, cone], axis=1).astype(np.float32)


def build_dense(geom: Geometry, n_instances: int) -> DenseLayout:
    """The dense search's tables, on the device of `geom`."""
    tri = geom.tri_packed.detach().cpu().numpy()
    table = build_tri_table(tri)
    lo, hi = tri_bounds(tri)
    mu = tri_shape(tri)
    nh = tri_normals(tri)
    meshes = mesh_leaf_rows(geom)
    leaf = np.arange(table.shape[0], dtype=np.int32)
    index = np.zeros((len(meshes), 2), np.int32)
    roots = np.zeros((len(meshes), 12), np.float32)
    blocks, groups = [], []
    n_blocks = n_groups = 0
    for m, (base, n, order) in enumerate(meshes):
        index[m] = (n_blocks, n_groups)
        if n == 0:
            continue
        order = leaf_groups(order, nh, lo, hi)
        leaf[base:base + n] = order
        mlo, mhi, mmu, mnh = lo[order], hi[order], mu[order], nh[order]
        roots[m] = _boxes(mlo, mhi, mmu, mnh, n)[0]
        blocks.append(_boxes(mlo, mhi, mmu, mnh, TILE))
        groups.append(_boxes(mlo, mhi, mmu, mnh, GROUP))
        n_blocks += blocks[-1].shape[0]
        n_groups += groups[-1].shape[0]
    kind = geom.inst_kind.cpu().numpy()
    obj = geom.inst_obj.cpu().numpy()
    plan = np.zeros((n_instances, 4), np.int32)
    for i in range(n_instances):
        k, o = int(kind[i]), int(obj[i])
        first, n = meshes[o][:2] if k == INST_MESH else (0, 0)
        plan[i] = (k, first, n, o)
    dev = geom.tri_packed.device

    def dev_t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def stack(boxes):
        return np.concatenate(boxes) if boxes else np.zeros((0, 12),
                                                            np.float32)
    return DenseLayout(plan=dev_t(plan),
                       leaf_table=dev_t(table[leaf]),
                       leaf_ids=dev_t(leaf), mesh_index=dev_t(index),
                       root_box=dev_t(roots), block_box=dev_t(stack(blocks)),
                       group_box=dev_t(stack(groups)))


def pair_tests(rows, o, d, w) -> tuple:
    """Each ray's pair test against each row of `rows` (C, 16): (t,
    valid) (B, C), valid where 0 <= t and (u, v) lies in the triangle (no
    bound on t). Each quantity is the explicit sum of its products in
    phi's feature order, two roundings a term, as the kernel computes
    it."""
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
    return t, (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)


def _block_min(rows, o, d, w, best_t):
    """Closest valid triangle of `rows` (C, 16) for each ray: (t, j), t
    +inf where none is valid (`pair_tests` with t < best_t), j the lowest
    row index of the minimum."""
    t, valid = pair_tests(rows, o, d, w)
    t = torch.where(valid & (t < best_t[:, None]), t, float("inf"))
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
    table = dense.table
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
            rows = table[first + c:first + min(c + chunk, n)]
            t, j = _block_min(rows, o, d, w, best_t)
            upd = t < best_t
            best_t = torch.where(upd, t, best_t)
            best_prim = torch.where(upd, first + c + j, best_prim)
            best_inst = torch.where(upd, i, best_inst)
    dead = ~(limit > 0.0)
    return Hit(t=torch.where(dead, FLT_MAX, best_t),
               prim=torch.where(dead, -1, best_prim).to(torch.int32),
               inst=torch.where(dead, -1, best_inst).to(torch.int32))


def cull_ray(o, d):
    """The box test's per-(ray, instance) terms of the instance-space ray
    (o, d) (B, 3), as the kernel computes them: 1/d (correctly rounded),
    d's sign bits, O = max |o_i|, MARGIN_ABS / A, A = max |d_i|, d and
    |d| (a correctly rounded root)."""
    inv = torch.ones_like(d) / d
    neg = torch.signbit(d)
    O = o.abs().amax(dim=1)
    A = d.abs().amax(dim=1)
    dn = vm.ieee_sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                      + d[:, 2] * d[:, 2])
    # tensor divisions (a Python scalar over a tensor multiplies by its
    # reciprocal, which is not correctly rounded)
    return inv, neg, O, torch.full_like(A, MARGIN_ABS) / A, d, A, dn


def _cross(a, b):
    """a x b of (..., 3) tensors, each component one difference of two
    products, as the kernel computes it."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _norm3(x):
    return vm.ieee_sqrt((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])
                        + x[..., 2] * x[..., 2])


def slab_keep(box, o, cr, best):
    """The slab test of `box_keep`: (B, K) bool, the slab interval of
    each box inflated by MARGIN_BOX * (V + O) * F, widened, against [-tm,
    best * (1 + MARGIN_REL * F) + tm], tm = kA * (V + O) * F."""
    inv, neg, O, kA, _, _, _ = cr
    lo, V, hi, F = box[:, 0:3], box[:, 3], box[:, 4:7], box[:, 7]
    sf = (O[:, None] + V[None, :]) * F[None, :]
    m = MARGIN_BOX * sf
    tm = kA[:, None] * sf
    rel = (MARGIN_REL * F + 1.0)[None, :]
    en = ex = None
    for a in range(3):
        ng = neg[:, a:a + 1]
        near = torch.where(ng, hi[None, :, a], lo[None, :, a])
        far = torch.where(ng, lo[None, :, a], hi[None, :, a])
        near = torch.where(ng, near + m, near - m)
        far = torch.where(ng, far - m, far + m)
        e = (near - o[:, a:a + 1]) * inv[:, a:a + 1]
        x = (far - o[:, a:a + 1]) * inv[:, a:a + 1]
        en = e if en is None else torch.fmax(en, e)
        ex = x if ex is None else torch.fmin(ex, x)
    en = torch.where(en > 0.0, en * WIDEN_DN, en * WIDEN_UP) - FLT_MIN
    ex = torch.where(ex > 0.0, ex * WIDEN_UP, ex * WIDEN_DN) + FLT_MIN
    tlim = (best if best.dim() == 2 else best[:, None]) * rel + tm
    return ~((en > ex) | (en > tlim) | (ex < -tm))


def plane_keep(box, o, cr):
    """The plane test of `box_keep`: (B, K) bool, false where |M x c| >
    (S |M| + T) * SLACK for the moment M = (centre - o) x d of the ray's
    line about the box's centre (lo + hi) * 0.5, T = |d| (K_R L_B + E_V V
    + E_X max |centre - o|) + A (K_T L_B + C_W (V + O) F)."""
    _, _, O, _, d, A, dn = cr
    lo, V, hi, F = box[:, 0:3], box[:, 3], box[:, 4:7], box[:, 7]
    c, S = box[:, 8:11], box[:, 11]
    sf = (O[:, None] + V[None, :]) * F[None, :]
    x = (lo + hi) * 0.5 - o[:, None, :]                       # (B, K, 3)
    X = torch.fmax(torch.fmax(x[..., 0].abs(), x[..., 1].abs()),
                   x[..., 2].abs())
    M = _cross(x, d[:, None, :])
    q = _cross(M, c[None])
    ext = hi - lo
    LB = torch.fmax(torch.fmax(ext[:, 0], ext[:, 1]), ext[:, 2])
    reach = K_R * LB + E_V * V
    T = (dn[:, None] * (reach[None, :] + E_X * X)
         + A[:, None] * (K_T * LB[None, :] + C_W * sf))
    return ~(_norm3(q) > (S[None, :] * _norm3(M) + T) * SLACK)


def box_keep(box, o, cr, best):
    """Whether each ray may use each box: (B, K) bool for boxes (K, 12)
    [lo, V, hi, F, c, S], rays o (B, 3) with cull_ray terms `cr`, and
    running best (B,), or (B, K), one for each box: the slab test
    (`slab_keep`) or the plane test (`plane_keep`). The kernel's
    `box_keep`, operation for operation (IEEE round to nearest, roots
    correctly rounded; fmax and fmin drop a NaN; a NaN comparison
    keeps)."""
    return slab_keep(box, o, cr, best) | plane_keep(box, o, cr)


def _group_min(rows, ids, o, d, w):
    """Each ray's best pair of each GROUP-row group of `rows` (C, 16)
    with triangle ids (C,): (t, id) (B, ceil(C / GROUP)), the least t of
    the group's valid pairs (`pair_tests`) and the least id among equal t
    (that pair's t); t +inf where none is valid."""
    t, valid = pair_tests(rows, o, d, w)
    t = torch.where(valid, t, float("inf"))
    C = rows.shape[0]
    pad = -C % GROUP
    idx = ids.long()[None, :].expand_as(t)
    if pad:
        t = torch.cat([t, t.new_full((t.shape[0], pad), float("inf"))], 1)
        idx = torch.cat([idx, idx.new_zeros((t.shape[0], pad))], 1)
    t = t.view(t.shape[0], -1, GROUP)
    idx = idx.reshape(t.shape)
    # the least id among the least t, and that pair's own t (its sign of
    # zero included)
    key = torch.where(t == t.amin(dim=2, keepdim=True), idx,
                      torch.iinfo(torch.int64).max)
    pos = key.argmin(dim=2, keepdim=True)
    return t.gather(2, pos)[..., 0], key.gather(2, pos)[..., 0]


def dense_cull_plain(geom: Geometry, dense: DenseLayout, o_w, d_w,
                     limit) -> tuple:
    """A plain model of K3 as it runs: each mesh's rows in leaf order
    (`leaf_table`), group by group under the kernel's tie rule, and the
    box decisions the kernel takes on the way. Returns (Hit, cull): Hit
    equals dense_hit_plain's bit for bit (the tests hold it to that);
    cull has one dict per searched mesh instance, {"inst", "root" (B,),
    "block" (B, S_m), "group" (B, G_m)}: bool votes of each live lane for
    the instance's root box, each superblock box (against its best where
    the kernel gathers the superblock votes: each SB_CHUNK superblocks)
    and each group box (against its best when the kernel reaches the
    group), each vote anded with the root's. A lane tests a group's rows
    only where its group vote holds (its warp runs them where any lane's
    does, in superblocks any lane of its block voted for). Nothing on
    the card's path calls it."""
    B = o_w.shape[0]
    dev = o_w.device
    live = limit > 0.0
    best_t = limit.clone()
    best_prim = torch.full((B,), -1, dtype=torch.int64, device=dev)
    best_inst = torch.full((B,), -1, dtype=torch.int64, device=dev)
    index = dense.mesh_index.tolist()
    culls = []
    chunk = max(PLAIN_CHUNK_ELEMS // max(B, 1) // TILE, 1) * TILE
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
        cr = cull_ray(o, d)
        sb0, g0 = index[obj]
        ng = -(-n // GROUP)
        nb = -(-ng // SUPER)
        root = live & box_keep(dense.root_box[obj:obj + 1], o, cr,
                               best_t)[:, 0]
        here = torch.zeros((B,), dtype=torch.bool, device=dev)
        before = torch.empty((B, ng), dtype=best_t.dtype, device=dev)
        for c in range(0, n, chunk):
            tg, idg = _group_min(dense.leaf_table[first + c:first + min(
                c + chunk, n)], dense.leaf_ids[first + c:first + min(
                    c + chunk, n)], o, d, w)
            for k in range(tg.shape[1]):
                before[:, c // GROUP + k] = best_t
                t, j = tg[:, k], idg[:, k]
                upd = (t < best_t) | ((t == best_t) & here & (j < best_prim))
                best_t = torch.where(upd, t, best_t)
                best_prim = torch.where(upd, j, best_prim)
                best_inst = torch.where(upd, i, best_inst)
                here = here | upd
        group = torch.cat([
            box_keep(dense.group_box[g0 + k:g0 + min(k + VOTE_CHUNK, ng)],
                     o, cr, before[:, k:k + VOTE_CHUNK])
            for k in range(0, ng, VOTE_CHUNK)], 1) & root[:, None]
        block = torch.cat([
            box_keep(dense.block_box[sb0 + k:sb0 + min(k + VOTE_CHUNK, nb)],
                     o, cr, before[:, k // SB_CHUNK * SB_CHUNK * SUPER])
            for k in range(0, nb, VOTE_CHUNK)], 1) & root[:, None]
        culls.append({"inst": i, "root": root, "block": block,
                      "group": group})
    dead = ~live
    hit = Hit(t=torch.where(dead, FLT_MAX, best_t),
              prim=torch.where(dead, -1, best_prim).to(torch.int32),
              inst=torch.where(dead, -1, best_inst).to(torch.int32))
    return hit, culls


def dense_hit(geom: Geometry, o_w, d_w, limit, dense: DenseLayout) -> Hit:
    """Closest hit of each ray (o_w, d_w (B, 3)) under its limit (B,) by
    the dense search. CPU tensors: the plain version. CUDA tensors: the
    K3 kernel, or an error. Returns Hit(t f32, prim i32 (-1 sphere), inst
    i32 (-1 miss)) with closest_hit's conventions; t is the search's own
    (K1 recomputes the winner's)."""
    if o_w.device.type == "cpu":
        return dense_hit_plain(geom, dense, o_w, d_w, limit)
    B = o_w.shape[0]
    P, I = dense.leaf_table.shape[0], dense.plan.shape[0]
    M = dense.mesh_index.shape[0]
    check = cuda_build.check_tensor
    check(o_w, "o_w", torch.float32, (B, 3))
    check(d_w, "d_w", torch.float32, (B, 3))
    check(limit, "limit", torch.float32, (B,))
    check(dense.leaf_table, "leaf_table", torch.float32, (P, 16), align=16)
    check(dense.leaf_ids, "leaf_ids", torch.int32, (P,))
    check(dense.plan, "plan", torch.int32, (I, 4), align=16)
    check(dense.mesh_index, "mesh_index", torch.int32, (M, 2), align=8)
    check(dense.root_box, "root_box", torch.float32, (M, 12), align=16)
    for name in ("block_box", "group_box"):
        box = getattr(dense, name)
        check(box, name, torch.float32, (box.shape[0], 12), align=16)
    for name in ("inst_Ainv", "inst_offset", "sph_radius"):
        check(getattr(geom, name), name, torch.float32)
    dev = o_w.device
    t = torch.empty(B, dtype=torch.float32, device=dev)
    prim = torch.empty(B, dtype=torch.int32, device=dev)
    inst = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return Hit(t=t, prim=prim, inst=inst)
    fn = cuda_build.function("dense_hit", "craytpu_dense_hit",
                             "pppi" + "ppp" + "i" + "p" * 7 + "f" * 9
                             + "p" * 4)
    tables = (dense.leaf_table, dense.leaf_ids, dense.plan)
    boxes = (dense.mesh_index, dense.root_box, dense.block_box,
             dense.group_box, geom.inst_Ainv, geom.inst_offset,
             geom.sph_radius)
    cuda_build.launch(
        "dense_hit", fn, o_w.data_ptr(), d_w.data_ptr(), limit.data_ptr(),
        B, *(x.data_ptr() for x in tables), I,
        *(x.data_ptr() for x in boxes), MARGIN_BOX, MARGIN_REL, MARGIN_ABS,
        K_T, C_W, K_R, E_V, E_X, SLACK,
        t.data_ptr(), prim.data_ptr(), inst.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, size=B)
    dense_hit.launches += 1
    return Hit(t=t, prim=prim, inst=inst)


dense_hit.launches = 0
