"""The port's runtime switches on the CPU, against craytpu where craytpu
has the same switch: CRAYTPU_FASTMATH (the float layer's plain forms),
CRAYTPU_HITREC (checked; every value takes K1's wrapper),
CRAYTPU_CACHE (the kernels' build directory), and the inventory of every
CRAYTPU_* name craytpu reads.

Tolerances: the fast-math primitives and the xla record are bit-equal
(the same ops on the same lanes). Frames of the two
packages are held to the golden thresholds of craytpu/utils/golden.py:
26-27 on sRGB u8 (golden.compare_u8): diffuse scatter calls sin/cos,
whose libm results differ between XLA and PyTorch in the last bits.

craytpu tests its fast-math flag (craytpu.ops.vecmath._FASTMATH) while
it traces; the tests set it and the port's flag with monkeypatch, on
renderers built inside the patched block, and edit nothing in craytpu/.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import craytpu.ops.vecmath as jvm
from craytpu.models.wavefront_pt import render as jrender
from craytpu.scene.compile import compile_scene as jcompile
from craytpu_torch.models.wavefront_pt import WavefrontRenderer, render
from craytpu_torch.ops import cuda_build
from craytpu_torch.ops import hitrec as hr
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.utils import golden
from tests.test_torch_scene import load_pair

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"width": 16, "height": 16, "samples": 1, "bounces": 3}


def assert_bits(got, want, name):
    g = np.ascontiguousarray(np.asarray(got, np.float32))
    w = np.ascontiguousarray(np.asarray(want, np.float32))
    assert g.shape == w.shape, (name, g.shape, w.shape)
    bad = (g.view(np.uint32) != w.view(np.uint32)) & ~(np.isnan(g)
                                                        & np.isnan(w))
    assert not bad.any(), f"{name}: {bad.sum()} of {bad.size} differ"


def assert_frames_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    ok, within, mean_abs = golden.compare_u8(golden.srgb_u8(got),
                                             golden.srgb_u8(want))
    assert ok, (within, mean_abs)


@pytest.fixture
def fastmath(monkeypatch):
    """Both packages' CRAYTPU_FASTMATH flag on."""
    monkeypatch.setattr(vm, "_FASTMATH", True)
    monkeypatch.setattr(jvm, "_FASTMATH", True)


def operands(n: int = 4096, seed: int = 17):
    """Three (n, 3) f32 operand arrays over many magnitudes and signs,
    with zeros of both signs and exact ties in their first rows."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(3, n, 3))
         * 10.0 ** rng.uniform(-6, 6, (3, n, 3))).astype(np.float32)
    x[:, :4] = [[0.0, -0.0, 1.0], [2.0, 0.5, -3.0], [1e-30, 1e30, 7.0],
                [-0.0, 4.0, 0.25]]
    return x


# each primitive as (its arity, a function of the module vecmath)
PRIMITIVES = {
    "exact_div": (2, lambda m, a, b: m.exact_div(a, b)),
    "exact_sqrt": (1, lambda m, a: m.exact_sqrt(abs(a))),
    "fma_raw": (3, lambda m, a, b, c: m.fma_raw(a, b, c)),
    "det_fma": (3, lambda m, a, b, c: m.det_fma(a, b, c)),
    # _fma_pre, the split-sharing form inside the crosses and transforms
    "vcross": (2, lambda m, a, b: m.vcross(a, b)),
}


@pytest.mark.parametrize("name", list(PRIMITIVES))
def test_fastmath_primitives_match_craytpu(name, fastmath, monkeypatch):
    """Under CRAYTPU_FASTMATH each primitive is craytpu's plain form, bit
    for bit. The fma forms then round twice, so they differ from the
    exact forms (division and sqrt are correctly rounded on the CPU
    either way)."""
    arity, fn = PRIMITIVES[name]
    x = operands()[:arity]
    got = fn(vm, *[torch.from_numpy(a) for a in x])
    want = fn(jvm, *[jnp.asarray(a) for a in x])
    assert_bits(got.numpy(), np.asarray(want), name)
    monkeypatch.setattr(vm, "_FASTMATH", False)
    exact = fn(vm, *[torch.from_numpy(a) for a in x])
    if arity == 3 or name == "vcross":
        assert not torch.equal(exact, got)


def test_fastmath_keeps_the_derivative_rules(fastmath):
    a = torch.tensor([1.5, -2.0], requires_grad=True)
    b = torch.tensor([0.5, 4.0], requires_grad=True)
    q = vm.exact_div(a, b)
    q.sum().backward()
    assert torch.equal(q.detach(), a.detach() / b.detach())
    assert torch.allclose(a.grad, 1.0 / b.detach())
    assert torch.allclose(b.grad, -q.detach() / b.detach())


def test_fastmath_render_matches_craytpu(fastmath):
    """A 16x16 1-spp frame of entry_scene under fast math in both
    packages, within the golden thresholds."""
    jscene, tscene = load_pair("entry_scene", TINY)
    want = np.asarray(jrender(jcompile(jscene), spp=1))
    got = render(compile_scene(tscene, "cpu"), spp=1)
    assert_frames_close(got, want)


def test_hitrec_switch(monkeypatch, capsys):
    """CRAYTPU_HITREC=xla takes the records from K1's wrapper, as the
    default does (on the CPU, its plain version: craytpu's XLA twin), so
    the two are bit-equal; one notice a process; an unknown value
    raises."""
    _, tscene = load_pair("entry_scene", TINY)
    cs = compile_scene(tscene, "cpu")
    r = WavefrontRenderer(cs)
    xs, ys, _, T = r._pixel_schedule
    o, d, _ = r._init_rays(xs[:T], ys[:T], 0, 1)
    alive = torch.arange(T) % 5 != 0
    kernel = r.isect.search(cs.geom, o, d, alive)
    monkeypatch.setattr(hr, "_XLA_NOTICE", [])
    monkeypatch.setenv("CRAYTPU_HITREC", "xla")
    capsys.readouterr()
    rx = WavefrontRenderer(cs)
    assert "CRAYTPU_HITREC=xla" in capsys.readouterr().err
    hr.Isect(cs, cs.geom.tri_packed)
    assert capsys.readouterr().err == ""
    xla = rx.isect.search(cs.geom, o, d, alive)
    assert (kernel[2] >= 0).any()
    for a, b, name in zip(kernel, xla, ("t", "prim", "inst", "record")):
        assert_bits(a.float().numpy(), b.float().numpy(), name)
    want = hr.hitrec_plain(cs.tri_wide, cs.inst_wide, o, d, *kernel[:3],
                           cs.sphere_uv)
    assert_bits(xla[3].numpy(), want.numpy(), "plain record")
    monkeypatch.setenv("CRAYTPU_HITREC", "pallas")
    with pytest.raises(ValueError, match="CRAYTPU_HITREC"):
        WavefrontRenderer(cs)


def test_cache_names_the_build_directory(monkeypatch, tmp_path):
    """CRAYTPU_CACHE names the directory the kernels build into (else
    build/craytpu_torch/); each kernel's exact and fast variants have
    distinct names and hashes, and a process's flag picks its variant."""
    monkeypatch.delenv("CRAYTPU_CACHE", raising=False)
    default = os.path.join(REPO, "build", "craytpu_torch")
    assert cuda_build.build_dir() == default
    assert os.path.dirname(cuda_build.lib_path("hitrec", False)) == default
    monkeypatch.setenv("CRAYTPU_CACHE", str(tmp_path))
    for name in cuda_build.KERNELS:
        exact = cuda_build.lib_path(name, False)
        fast = cuda_build.lib_path(name, True)
        assert os.path.dirname(exact) == os.path.dirname(fast) == str(
            tmp_path)
        assert re.fullmatch(rf"lib{name}-[0-9a-f]{{16}}\.so",
                            os.path.basename(exact))
        assert re.fullmatch(rf"lib{name}_fast-[0-9a-f]{{16}}\.so",
                            os.path.basename(fast))
        assert exact[-19:] != fast[-19:]
        assert cuda_build.lib_path(name) == exact
        monkeypatch.setattr(vm, "_FASTMATH", True)
        assert cuda_build.lib_path(name) == fast
        monkeypatch.setattr(vm, "_FASTMATH", False)
    assert "-DCRAYTPU_FASTMATH=1" in cuda_build._flags(True)
    assert "-DCRAYTPU_FASTMATH=1" not in cuda_build._flags(False)
    assert not os.listdir(tmp_path)      # nothing is built by a path query


def test_fastmath_read_at_import():
    """CRAYTPU_FASTMATH, read when vecmath is imported: set, in a fresh
    process of the port alone; unset (as in this process), off."""
    code = ("from craytpu_torch.ops import vecmath as vm; "
            "print(vm._FASTMATH)")
    env = dict(os.environ, PYTHONPATH=REPO, CRAYTPU_FASTMATH="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["True"]
    if "CRAYTPU_FASTMATH" not in os.environ:
        assert vm._FASTMATH is False


SWITCH = re.compile(r"CRAYTPU_[A-Z0-9_]+")


def switch_names(package: str) -> set:
    """Every CRAYTPU_* name in a package's Python sources."""
    names = set()
    root = os.path.join(REPO, package)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    names |= set(SWITCH.findall(fh.read()))
    return names


def readme_switches() -> dict:
    """The README's table of craytpu's switches: name -> the port's
    counterpart column."""
    rows = {}
    with open(os.path.join(REPO, "README.md")) as f:
        for line in f:
            m = re.match(r"\s*\| `(CRAYTPU_[A-Z0-9_]+)` \| ([^|]*) \|",
                         line)
            if m:
                rows[m.group(1)] = m.group(2).strip()
    return rows


def test_every_craytpu_switch_is_read_or_documented():
    """Every CRAYTPU_* name craytpu/ reads is read by craytpu_torch/ or
    stands in the README's table as having no counterpart, with its
    reason; every row of the table is a name craytpu reads."""
    craytpu_names = switch_names("craytpu")
    port_names = switch_names("craytpu_torch")
    table = readme_switches()
    assert len(craytpu_names) > 20
    none = {n for n, where in table.items() if where.startswith("none")}
    missing = craytpu_names - port_names - none
    assert not missing, f"neither read by the port nor documented: {missing}"
    assert not none & port_names, none & port_names
    assert set(table) == craytpu_names, set(table) ^ craytpu_names
