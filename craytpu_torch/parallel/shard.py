"""The inverse-rendering train step on one card: the port of the JAX
package's parallel/shard.py (pad_to, make_sharded_render_fn, make_loss_fn,
make_geom_loss_fn, make_train_step).

The JAX package runs these over a (sample, rays) device mesh. Here the
mesh argument becomes n_sample, the size of the sample axis: each of
n_sample passes (base_pass + i, of n_sample) traces the whole ray batch,
one after another on the scene's device, and their radiance is averaged,
as the mesh's pmean over the sample axis does. The ray axis is the whole
batch. Sharding over several cards (torch.distributed) and make_mesh are
not ported yet (ROADMAP.md item 15b); with more than one card visible the
functions say so and run on the scene's device.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any

import numpy as np
import torch

from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.ops.edge_grad import make_edge_grad_fn
from craytpu_torch.utils import logging

# optax.adam's defaults (its eps_root is 0)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _one_card(r: WavefrontRenderer) -> None:
    if r.device.type == "cuda" and torch.cuda.device_count() > 1:
        logging.info("%d CUDA devices visible; training on %s only (the "
                     "sharded train step is ROADMAP.md item 15b)",
                     torch.cuda.device_count(), r.device)


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


def make_sharded_render_fn(r: WavefrontRenderer, n_sample: int = 1,
                           depth: int | None = None):
    """render(params, xs, ys, base_pass) -> (B, 4) radiance, averaged over
    passes base_pass .. base_pass + n_sample - 1 of n_sample."""
    _one_card(r)
    trace = r.make_trace_fn(depth)

    def render(params, xs, ys, base_pass: int):
        return _mean([trace(params, xs, ys, int(base_pass) + i, n_sample)
                      for i in range(n_sample)])

    return render


def make_loss_fn(r: WavefrontRenderer, n_sample: int = 1,
                 depth: int | None = None):
    """loss(params, xs, ys, target, base_pass) -> scalar: the mean squared
    error of the sample-averaged radiance against target (B, 3)."""
    render = make_sharded_render_fn(r, n_sample, depth)

    def loss(params, xs, ys, target, base_pass: int):
        return _mse(render(params, xs, ys, base_pass), target)

    return loss


def make_geom_loss_fn(r: WavefrontRenderer, n_sample: int = 1, scene=None,
                      depth: int | None = None, edge_samples: int = 32):
    """Like make_loss_fn but ALSO differentiable w.r.t. geometry:

      loss(params, tri_packed, xs, ys, target, base_pass) -> scalar

    The interior term uses the vertex-differentiable trace
    (diff_geometry=True: hit records recomputed from tri_packed) and the
    silhouette discontinuity enters through the edge-aware boundary
    estimator (ops/edge_grad.py): its zero forward, gathered at the batch's
    pixels, is added to each pass's radiance, so its backward receives the
    batch's cotangent scattered into a frame-sized buffer. `scene` is the
    loaded scene (the edge table's source)."""
    if scene is None:
        raise ValueError("geometry=True needs the loaded scene "
                         "(edge table source)")
    _one_card(r)
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
        u = m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        out.append(x + (-lr) * u)
        mu.append(m)
        nu.append(v)
    return out, AdamState(_like(state.mu, mu), _like(state.nu, nu), count)


def make_train_step(r: WavefrontRenderer, n_sample: int = 1,
                    depth: int | None = None, learning_rate: float = 1e-2,
                    geometry: bool = False, scene=None,
                    edge_samples: int = 32):
    """Full inverse-rendering training step on the scene's device.

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
    if geometry:
        geom_loss = make_geom_loss_fn(r, n_sample, scene, depth,
                                      edge_samples)

        def loss_fn(theta, xs, ys, target, base_pass):
            params, tri_packed = theta
            return geom_loss(params, tri_packed, xs, ys, target, base_pass)
    else:
        loss_fn = make_loss_fn(r, n_sample, depth)

    def step(theta, opt_state: AdamState, xs, ys, target, base_pass: int):
        leaves = [x.detach().requires_grad_() for x in _leaves(theta)]
        loss = loss_fn(_like(theta, leaves), xs, ys, target, base_pass)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        with torch.no_grad():
            new, opt_state = _adam([x.detach() for x in leaves], grads,
                                   opt_state, learning_rate)
        return _like(theta, new), opt_state, loss.detach()

    def init(theta) -> AdamState:
        zeros = [torch.zeros_like(x) for x in _leaves(theta)]
        return AdamState(_like(theta, zeros), _like(theta, list(zeros)), 0)

    return step, init
