"""The persistent pool's refill quantum and the helpers the port gained
beside it, on the CPU against craytpu: a rank of a group refills by a
quarter of its pool, as craytpu's ShardedPoolRenderer, and one card by a
sixteenth; radical_inverse, the color ops, and golden.scene_path and
render_and_compare.

Tolerances: radical_inverse and the linear color ops are bit-equal; the
sRGB encode, a float power, within rtol 1e-6 (XLA's and PyTorch's powf
may differ in the last bit). A group's 16x16 frame against one card's
within the resume tolerance, rtol 2e-5, atol 2e-6 (tests/test_
persistent.py: the same per-(pixel, pass) streams summed in another
order).

The 2-rank group's processes start first and run beside the rest of
the file (tests/test_torch_dist_render.py does the same).
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import craytpu.ops.colorops as jco
import craytpu.ops.pcg as jpcg
from craytpu.utils import golden as jgolden
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.ops import colorops, pcg
from craytpu_torch.parallel import dist
from craytpu_torch.parallel.pool_shard import ShardedPoolRenderer
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.utils import golden
from tests import torch_dist_ranks as ranks
from tests.test_torch_scene import load_pair

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 2e-6
TINY = {"width": 16, "height": 16}
TILE_RAYS = 128


def in_thread(fn, *args, **kw):
    """Run fn(*args, **kw) in a thread; .result() joins it and returns or
    raises."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 - raised in result()
            box["err"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()

    class Handle:
        @staticmethod
        def result():
            t.join(timeout=300)
            if "err" in box:
                raise box["err"]
            return box["out"]
    return Handle


@pytest.fixture(scope="module", autouse=True)
def group():
    """The 2-rank group's frame (processes of the port alone), started at
    the file's first test and collected by its last, which needs it."""
    return in_thread(dist.spawn_local, 2, ranks.pool_quantum_group, TINY,
                     TILE_RAYS, 4, device="cpu", threads=1, timeout_s=300)


@pytest.mark.parametrize("cls,B,Q", [
    (WavefrontRenderer, 8192, 512), (WavefrontRenderer, 128, 8),
    (WavefrontRenderer, 8, 1), (ShardedPoolRenderer, 8192, 2048),
    (ShardedPoolRenderer, 128, 32), (ShardedPoolRenderer, 2, 1)])
def test_refill_quantum(cls, B, Q):
    """One card refills by B // 16 (craytpu's wavefront_pt.py:1405), a
    rank of a group by max(B // 4, 1) (craytpu's pool_shard.py:534); the
    port keeps at least one lane a quantum on one card too."""
    assert cls.refill_quantum(cls.__new__(cls), B) == Q


@pytest.mark.parametrize("base", [2, 3, 5, 13])
def test_radical_inverse_matches_craytpu(base):
    idx = np.concatenate([np.arange(300), [4095, 65535, 2 ** 20 + 7,
                                           2 ** 31 - 1]]).astype(np.int32)
    got = pcg.radical_inverse(torch.from_numpy(idx), base).numpy()
    want = np.asarray(jax.jit(jax.vmap(
        lambda p: jpcg.radical_inverse(p, base)))(jnp.asarray(idx)))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.astype(np.float32).view(np.uint32))
    assert got.max() <= np.float32(0.99999994)


def test_color_ops_match_craytpu():
    rng = np.random.default_rng(9)
    a = rng.uniform(-0.1, 2.0, (512, 4)).astype(np.float32)
    b = rng.uniform(0.0, 1.0, (512, 4)).astype(np.float32)
    a[:4, 0] = [0.0, 0.0031308, 0.00313, -0.0]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(colorops.rgba(0.25, 0.5, 1.0).numpy(),
                                  np.asarray(jco.rgba(0.25, 0.5, 1.0)))
    np.testing.assert_array_equal(colorops.rgba(0.1, 0.2, 0.3, 0.4).numpy(),
                                  np.asarray(jco.rgba(0.1, 0.2, 0.3, 0.4)))
    np.testing.assert_array_equal(colorops.color_mul(ta, tb).numpy(),
                                  np.asarray(jco.color_mul(ja, jb)))
    np.testing.assert_array_equal(colorops.color_add(ta, tb).numpy(),
                                  np.asarray(jco.color_add(ja, jb)))
    np.testing.assert_allclose(colorops.linear_to_srgb(ta).numpy(),
                               np.asarray(jco.linear_to_srgb(ja)),
                               rtol=1e-6, atol=0)
    got = colorops.color_to_srgb(ta).numpy()
    np.testing.assert_allclose(got, np.asarray(jco.color_to_srgb(ja)),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[:, 3], a[:, 3])


def test_render_and_compare_matches_craytpu():
    """render_and_compare (on the CPU here) for a size with no golden:
    the tuple that craytpu's compare gives there."""
    got = golden.render_and_compare("stress_highpoly", 16, 10, 1,
                                    device="cpu")
    want = jgolden.compare(np.zeros((10, 16, 4), np.float32),
                           "stress_highpoly", 16, 10, 1)
    assert got == want == (None, 0.0, 0.0)


def test_scene_path(tmp_path):
    """Stress scenes come from assets/, as craytpu's do; the others from
    the corpus directory the caller names, and without one the call
    raises rather than reading outside the repository."""
    assert golden.SCENES == jgolden.SCENES
    for name in ("stress_highpoly", "stress_instances"):
        assert golden.scene_path(name) == jgolden.scene_path(name)
        assert os.path.exists(golden.scene_path(name))
    for name in golden.SCENES:
        if not name.startswith("stress_"):
            assert golden.scene_path(name, str(tmp_path)) == str(
                tmp_path / f"{name}.json")
            with pytest.raises(FileNotFoundError, match=name):
                golden.scene_path(name)
    with pytest.raises(FileNotFoundError):
        golden.render_and_compare("scene", 16, 10, 1, device="cpu")


def test_sharded_pool_refills_by_a_quarter(group):
    """Each rank of a 2-rank group refills its pool of B lanes by
    max(B // 4, 1), as craytpu's ShardedPoolRenderer: its frame record
    accounts for every path of its share in quanta of B // 4 (the last
    refill takes what is left); the group's frame is the single-card
    frame within the resume tolerance."""
    out = group.result()
    npix = 16 * 16
    share = 2 * npix                      # passes [2r, 2r + 2) of 4
    for rank in out:
        assert rank["class"] == "ShardedPoolRenderer"
        B, Q, st = rank["B"], rank["Q"], rank["stats"]
        assert (B, Q) == (TILE_RAYS, TILE_RAYS // 4)
        refills = [(k[1], n) for k, n in st["hist"].items()
                   if k[0] == "refill"]
        assert st["counts"]["refills"] == sum(n for _, n in refills) >= 3
        fresh = sum(m * n for m, n in refills) * Q
        assert 0 <= fresh - (share - B) < 8 * Q
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CRAYTPU_POOL_K", "1")
        cs = compile_scene(load_pair("entry_scene", TINY)[1], "cpu")
        one = WavefrontRenderer(cs, tile_rays=TILE_RAYS).render_persistent(
            spp=4)
    np.testing.assert_allclose(out[0]["frame"], one, rtol=RTOL, atol=ATOL)
