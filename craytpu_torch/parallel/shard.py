"""The inverse-rendering train step: the port of the JAX package's
parallel/shard.py (make_mesh, pad_to, make_sharded_render_fn,
make_loss_fn, make_geom_loss_fn, make_train_step).

The JAX package runs these over a (sample, rays) device mesh from one
process. The port takes either form of that mesh:

  - an int n_sample, on one card: each of n_sample passes (base_pass + i,
    of n_sample) traces the whole ray batch, one after another on the
    scene's device, and their radiance is averaged, as the mesh's pmean
    over the sample axis does;
  - a (sample, rays) DeviceMesh over the ranks of the process group
    (make_mesh; one rank per card, parallel/dist.py): every rank gets
    the whole batch, traces its ray shard at pass base_pass + its sample
    index, and the pmean over "sample" and psum over "rays" become
    all_reduces on the mesh's sub-groups. Each rank takes the gradient
    of its own shard (a vector-Jacobian product with the loss's
    cotangent rows) and the ranks' gradients are summed over the group,
    which is the JAX step's gradient; the Adam update is then the same
    on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any

import numpy as np
import torch

from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.ops.edge_grad import make_edge_grad_fn
from craytpu_torch.parallel import dist
from craytpu_torch.utils import logging

RAY_AXIS = "rays"
SAMPLE_AXIS = "sample"

# optax.adam's defaults (its eps_root is 0)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def make_mesh(n_devices: int | None = None, n_sample: int | None = None):
    """A (sample, rays) DeviceMesh over the ranks of the process group.

    n_devices is the group's size (the mesh spans every rank); n_sample
    defaults to 2 when it is even and > 2 (so both axes are exercised),
    else 1. Rank i * (n_devices // n_sample) + j sits at (sample i, ray
    j), as the JAX package lays devices out."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(parallel/dist.py: init_distributed, "
                           "spawn_local)")
    world = dist.world_size()
    n_devices = world if n_devices is None else n_devices
    if n_devices != world:
        raise ValueError(f"the mesh spans the group's {world} ranks, not "
                         f"{n_devices}")
    if n_sample is None:
        n_sample = 2 if (n_devices % 2 == 0 and n_devices > 2) else 1
    if n_devices % n_sample:
        raise ValueError(f"{n_devices} ranks do not split into "
                         f"{n_sample} sample rows")
    grid = torch.arange(n_devices).reshape(n_sample, n_devices // n_sample)
    kind = "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, grid, mesh_dim_names=(SAMPLE_AXIS, RAY_AXIS))


class _MeshPlace:
    """This rank's place in a (sample, rays) DeviceMesh: the axis sizes
    S and R, its sample index i and ray index j, and the two sub-groups."""

    def __init__(self, mesh):
        self.S, self.R = mesh.size(0), mesh.size(1)
        self.i, self.j = mesh.get_coordinate()
        self.sample = mesh.get_group(SAMPLE_AXIS)
        self.rays = mesh.get_group(RAY_AXIS)

    def shard(self, x):
        """This rank's ray shard of a batch (its j-th of R)."""
        B = x.shape[0]
        if B % self.R:
            raise ValueError(f"a batch of {B} rays does not split over "
                             f"{self.R} ray shards (pad_to)")
        n = B // self.R
        return x[self.j * n:(self.j + 1) * n]

    def sample_mean(self, rad):
        """The pmean over the sample axis: the same on every rank."""
        if self.S == 1:
            return rad
        total = dist.all_reduce_sum_(rad.detach().clone(), self.sample)
        return total / total.new_tensor(float(self.S))

    def mse(self, mean, target):
        """(loss, cotangent of this rank's radiance): the mean squared
        error over the whole batch (psum over the ray axis) and its
        derivative with respect to the rank's own radiance rows."""
        t = self.shard(target)
        diff = mean[..., :3] - t
        err = diff * diff
        total = dist.all_reduce_sum_(err.sum(), self.rays)
        n = dist.all_reduce_sum_(total.new_tensor(float(err.numel())),
                                 self.rays)
        ct = torch.zeros_like(mean)
        ct[..., :3] = (2.0 * diff) / n / n.new_tensor(float(self.S))
        return total / n, ct


def _is_mesh(mesh) -> bool:
    return not isinstance(mesh, int)


def _mean(rads: list):
    """The mean of the sample axis's radiances (psum, then the division
    by the axis size, by a tensor: exact as the JAX package's)."""
    total = rads[0]
    for rad in rads[1:]:
        total = total + rad
    return total / total.new_tensor(float(len(rads)))


def _mse(rad, target):
    err = (rad[..., :3] - target) ** 2
    total = err.sum()
    return total / total.new_tensor(float(err.numel()))


def make_sharded_render_fn(r: WavefrontRenderer, n_sample=1,
                           depth: int | None = None):
    """render(params, xs, ys, base_pass) -> (B, 4) radiance, averaged over
    passes base_pass .. base_pass + n_sample - 1 of n_sample.

    n_sample: an int (one card), or a (sample, rays) mesh (make_mesh): the
    batch is split over the ray axis, and every rank returns the whole
    (B, 4) result (not differentiable; the loss functions are)."""
    trace = r.make_trace_fn(depth)
    if _is_mesh(n_sample):
        at = _MeshPlace(n_sample)

        def render_mesh(params, xs, ys, base_pass: int):
            rad = trace(params, at.shard(xs), at.shard(ys),
                        int(base_pass) + at.i, at.S)
            return dist.all_gather_cat(at.sample_mean(rad.detach()),
                                       at.rays)
        return render_mesh

    def render(params, xs, ys, base_pass: int):
        return _mean([trace(params, xs, ys, int(base_pass) + i, n_sample)
                      for i in range(n_sample)])

    return render


def make_loss_fn(r: WavefrontRenderer, n_sample=1,
                 depth: int | None = None):
    """loss(params, xs, ys, target, base_pass) -> scalar: the mean squared
    error of the sample-averaged radiance against target (B, 3). Over a
    mesh the loss is a value, the same on every rank (make_train_step
    takes its gradient)."""
    if _is_mesh(n_sample):
        vg = _mesh_value_and_grad(r, n_sample, depth)
        return lambda params, *a: vg(params, *a, grad=False)[0]
    render = make_sharded_render_fn(r, n_sample, depth)

    def loss(params, xs, ys, target, base_pass: int):
        return _mse(render(params, xs, ys, base_pass), target)

    return loss


def make_geom_loss_fn(r: WavefrontRenderer, n_sample=1, scene=None,
                      depth: int | None = None, edge_samples: int = 32):
    """Like make_loss_fn but ALSO differentiable w.r.t. geometry:

      loss(params, tri_packed, xs, ys, target, base_pass) -> scalar

    The interior term uses the vertex-differentiable trace
    (diff_geometry=True: hit records recomputed from tri_packed) and the
    silhouette discontinuity enters through the edge-aware boundary
    estimator (ops/edge_grad.py): its zero forward, gathered at the batch's
    pixels, is added to each pass's radiance, so its backward receives the
    batch's cotangent scattered into a frame-sized buffer. `scene` is the
    loaded scene (the edge table's source). Over a mesh each ray shard
    feeds the boundary term only its own pixels' cotangent rows, and the
    loss is a value as make_loss_fn's."""
    if scene is None:
        raise ValueError("geometry=True needs the loaded scene "
                         "(edge table source)")
    if _is_mesh(n_sample):
        vg = _mesh_value_and_grad(r, n_sample, depth, scene, edge_samples)
        return lambda params, tri_packed, *a: vg((params, tri_packed), *a,
                                                 grad=False)[0]
    d = depth if depth is not None else r.max_depth
    trace_g = r.make_trace_fn(d, diff_geometry=True)
    boundary = make_edge_grad_fn(r.cscene, scene, r, depth=d,
                                 samples_per_edge=edge_samples)
    width = r.width

    def loss(params, tri_packed, xs, ys, target, base_pass: int):
        flat = ys.long() * width + xs.long()
        rads = []
        for i in range(n_sample):
            p = int(base_pass) + i
            rad = trace_g(params, tri_packed, xs, ys, p, n_sample)
            rads.append(rad + boundary(params, tri_packed, p,
                                       n_sample)[flat])
        return _mse(_mean(rads), target)

    return loss


def _mesh_value_and_grad(r: WavefrontRenderer, mesh, depth, scene=None,
                         edge_samples: int = 32):
    """vg(theta, xs, ys, target, base_pass, grad=True) -> (loss, grads):
    the mesh's loss (make_loss_fn's, or make_geom_loss_fn's when `scene`
    is given and theta is (ShadeParams, tri_packed)) and, with grad, the
    group's gradient for each of theta's tensors (_leaves order), the same
    on every rank."""
    at = _MeshPlace(mesh)
    if scene is None:
        trace = r.make_trace_fn(depth)

        def rad_fn(theta, xs, ys, p):
            return trace(theta, xs, ys, p, at.S)
    else:
        d = depth if depth is not None else r.max_depth
        trace_g = r.make_trace_fn(d, diff_geometry=True)
        boundary = make_edge_grad_fn(r.cscene, scene, r, depth=d,
                                     samples_per_edge=edge_samples)
        width = r.width

        def rad_fn(theta, xs, ys, p):
            params, tri_packed = theta
            # the boundary term's backward gets this shard's cotangent
            # rows scattered into a frame-sized buffer
            flat = ys.long() * width + xs.long()
            return (trace_g(params, tri_packed, xs, ys, p, at.S)
                    + boundary(params, tri_packed, p, at.S)[flat])

    def vg(theta, xs, ys, target, base_pass: int, grad: bool = True):
        xs, ys = at.shard(xs), at.shard(ys)
        p = int(base_pass) + at.i
        if not grad:
            with torch.no_grad():
                rad = rad_fn(theta, xs, ys, p)
                return at.mse(at.sample_mean(rad), target)[0], None
        leaves = [x.detach().requires_grad_() for x in _leaves(theta)]
        rad = rad_fn(_like(theta, leaves), xs, ys, p)
        with torch.no_grad():
            loss, ct = at.mse(at.sample_mean(rad.detach()), target)
        grads = torch.autograd.grad(rad, leaves, grad_outputs=ct,
                                    allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        # one all_reduce of every table: the sum of the ranks' parts
        flat = dist.all_reduce_sum_(
            torch.cat([g.reshape(-1) for g in grads]))
        grads = [part.reshape(g.shape) for part, g in zip(
            torch.split(flat, [g.numel() for g in grads]), grads)]
        return loss, grads

    return vg


@dataclass
class AdamState:
    """optax.adam's state: first and second moments shaped as theta, and
    the number of steps taken."""
    mu: Any
    nu: Any
    count: int


def _leaves(theta) -> list:
    """theta's tensors: a ShadeParams's tables, or (ShadeParams,
    tri_packed)'s tables then tri_packed."""
    if isinstance(theta, tuple):
        params, tri_packed = theta
        return _leaves(params) + [tri_packed]
    return [getattr(theta, f.name) for f in fields(theta)]


def _like(theta, leaves: list):
    """A theta of the same structure holding `leaves`."""
    if isinstance(theta, tuple):
        params, _ = theta
        return (_like(params, leaves[:-1]), leaves[-1])
    return replace(theta, **{f.name: x for f, x in zip(fields(theta),
                                                       leaves)})


def _adam(leaves, grads, state: AdamState, lr: float):
    """One optax.adam(lr) update (bias-corrected): (new leaves, new
    state)."""
    b1, b2 = ADAM_B1, ADAM_B2
    count = state.count + 1
    # 1 - decay**count in float32, as optax computes it
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    mu, nu, out = [], [], []
    for x, g, m, v in zip(leaves, grads, _leaves(state.mu),
                          _leaves(state.nu)):
        m = (1 - b1) * g + b1 * m
        v = (1 - b2) * (g * g) + b2 * v
        m_hat = m / m.new_tensor(bc1)
        v_hat = v / v.new_tensor(bc2)
        u = m_hat / (vm.ieee_sqrt(v_hat) + ADAM_EPS)
        out.append(x + (-lr) * u)
        mu.append(m)
        nu.append(v)
    return out, AdamState(_like(state.mu, mu), _like(state.nu, nu), count)


def make_train_step(r: WavefrontRenderer, n_sample=1,
                    depth: int | None = None, learning_rate: float = 1e-2,
                    geometry: bool = False, scene=None,
                    edge_samples: int = 32):
    """Full inverse-rendering training step on the scene's device, or
    over the ranks of a (sample, rays) mesh (n_sample: an int, or
    make_mesh's mesh; every rank then calls step with the same whole
    batch and gets the same result).

    step(theta, opt_state, xs, ys, target, base_pass)
      -> (theta', opt_state', loss)

    theta is ShadeParams, or (ShadeParams, tri_packed) with geometry=True;
    init(theta) gives the optimiser's first state. The optimiser is
    optax.adam(learning_rate) (b1 0.9, b2 0.999, eps 1e-8).

    Differentiates the wavefront path trace w.r.t. every ShadeParams table
    (material colors, scalar values, vectors, texture texels, legacy
    emission/IOR) with the detached-sampling estimator, without remat.

    geometry=True (requires the loaded `scene` for the mesh edge table)
    additionally optimizes the packed triangle rows: interior vertex
    gradients through the differentiable hit records PLUS the edge-aware
    silhouette boundary term (make_geom_loss_fn). The closest-hit search
    keeps the scene's compile-time BVH and kernel layout (built once, never
    rebuilt between steps); only the hit records recompute from
    tri_packed. Recompile the scene every K steps if vertices move far.
    """
    if geometry and scene is None:
        raise ValueError("geometry=True needs the loaded scene "
                         "(edge table source)")
    if _is_mesh(n_sample):
        value_and_grad = _mesh_value_and_grad(
            r, n_sample, depth, scene if geometry else None, edge_samples)
    else:
        n = torch.cuda.device_count() if r.device.type == "cuda" else 0
        if n > 1:
            logging.info("%d CUDA devices visible; training on %s only. "
                         "To train on every card, run a rank per card "
                         "(torchrun --nproc-per-node %d) and pass "
                         "shard.make_mesh()", n, r.device, n)
        if geometry:
            geom_loss = make_geom_loss_fn(r, n_sample, scene, depth,
                                          edge_samples)

            def loss_fn(theta, xs, ys, target, base_pass):
                params, tri_packed = theta
                return geom_loss(params, tri_packed, xs, ys, target,
                                 base_pass)
        else:
            loss_fn = make_loss_fn(r, n_sample, depth)

        def value_and_grad(theta, xs, ys, target, base_pass):
            leaves = [x.detach().requires_grad_() for x in _leaves(theta)]
            loss = loss_fn(_like(theta, leaves), xs, ys, target, base_pass)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss, [torch.zeros_like(x) if g is None else g
                          for x, g in zip(leaves, grads)]

    def step(theta, opt_state: AdamState, xs, ys, target, base_pass: int):
        loss, grads = value_and_grad(theta, xs, ys, target, base_pass)
        with torch.no_grad():
            new, opt_state = _adam([x.detach() for x in _leaves(theta)],
                                   grads, opt_state, learning_rate)
        return _like(theta, new), opt_state, loss.detach()

    def init(theta) -> AdamState:
        zeros = [torch.zeros_like(x) for x in _leaves(theta)]
        return AdamState(_like(theta, zeros), _like(theta, list(zeros)), 0)

    return step, init
