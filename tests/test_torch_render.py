"""Whole-slice renders of the port on the CPU (the kernels' plain
versions), held to the golden thresholds of craytpu/utils/golden.py:26-27
(>= 0.985 of subpixels within 1 LSB, mean |d| <= 1.0) against the JAX
package's render of the same scene and against the C oracle's golden.
Images cannot be bit-equal: diffuse scatter calls sin/cos, whose libm
results differ between XLA and PyTorch in the last bits."""

import os

import numpy as np
import pytest
import torch

from craytpu.models.wavefront_pt import render as jrender
from craytpu.scene.compile import compile_scene as jcompile
from craytpu_torch.api import Renderer
from craytpu_torch.io.png import _to_srgb_u8, read_png_rgb
from craytpu_torch.models.wavefront_pt import render
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.utils import golden
from tests.test_render_smoke import SPHERE_SCENE
from tests.test_torch_scene import load_pair

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["sphere", "entry_scene"])
def test_render_matches_jax_package(name):
    jscene, tscene = load_pair(name, {"width": 32, "height": 24,
                                      "samples": 2})
    want = jrender(jcompile(jscene), spp=2)
    got = render(compile_scene(tscene, "cpu"), spp=2)
    assert got.shape == (24, 32, 4) and np.isfinite(got).all()
    ok, within, mean_abs = golden.compare_u8(golden.srgb_u8(got),
                                             golden.srgb_u8(want))
    assert ok, (within, mean_abs)


def test_render_matches_c_golden():
    """assets/stress_instances.json at 80x50, 4 spp against the C
    oracle's goldens/stress_instances_80_4.png."""
    _, tscene = load_pair("stress_instances",
                          {"width": 80, "height": 50, "samples": 4})
    fb = render(compile_scene(tscene, "cpu"), spp=4)
    ok, within, mean_abs = golden.compare(fb, "stress_instances", 80, 50, 4)
    assert ok, (within, mean_abs)


def test_renderer_writes_png(tmp_path):
    r = Renderer(device="cpu", overrides={"width": 24, "height": 16,
                                          "samples": 1})
    assert r.load_scene_from_file(os.path.join(REPO, "assets",
                                               "entry_scene.json"))
    r.set_output_path(str(tmp_path) + "/")
    r.start_renderer()
    path = r.write_image()
    assert path.endswith("entry_0000.png")
    img = read_png_rgb(path)
    assert img.shape == (16, 24, 3)
    np.testing.assert_array_equal(img, _to_srgb_u8(r.framebuffer)[::-1])


def test_render_deterministic():
    _, tscene = load_pair("sphere", {"width": 16, "height": 12})
    cs = compile_scene(tscene, "cpu")
    np.testing.assert_array_equal(render(cs, spp=1), render(cs, spp=1))


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, tscene = load_pair("sphere")
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_scene(tscene)
