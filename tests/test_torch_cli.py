"""The port's CLI (python -m craytpu_torch) on the CPU: the PNG it writes
against craytpu's CLI output for the same arguments, interrupt and
--resume of both checkpoint kinds, and the argument parser. The cluster,
preview, trace and test-dispatch flags: tests/test_torch_cli_tools.py.

Tolerance: images of the two packages (and of a resumed render against
an uninterrupted one) are held to the golden thresholds of
craytpu/utils/golden.py:26-27 on sRGB u8 (golden.compare_u8); the
progressive resume repeats the per-pass render's arithmetic exactly, so
its PNG is equal byte for byte."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from craytpu import main as jmain
from craytpu_torch import args as cliargs
from craytpu_torch import main as cli
from craytpu_torch.io.png import _to_srgb_u8, read_png_rgb
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.runtime import checkpoint
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.scene.sceneloader import load_scene_from_file
from craytpu_torch.utils import golden

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "assets", "entry_scene.json")
ARGS = [SCENE, "-s", "2", "-d", "32x24"]
PNG = os.path.join("output", "entry_0000.png")
CKPT = os.path.join("output", "entry.ckpt.npz")


def assert_png_close(got_path, want_path):
    ok, within, mean_abs = golden.compare_u8(read_png_rgb(got_path),
                                             read_png_rgb(want_path))
    assert ok, (within, mean_abs)


@pytest.fixture(scope="module")
def port_png(tmp_path_factory):
    """The port CLI's PNG for ARGS, uninterrupted."""
    d = tmp_path_factory.mktemp("port")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        assert cli.main(ARGS, device="cpu") == 0
    return str(d / PNG)


def test_cli_matches_jax_cli(port_png, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert jmain.main(ARGS) == 0
    assert read_png_rgb(port_png).shape == (24, 32, 3)
    assert_png_close(port_png, str(tmp_path / PNG))


def test_cli_interrupt_then_resume(port_png, tmp_path, monkeypatch):
    """The X key at the 3rd poll of the fast path checkpoints and exits
    130; --resume from that persistent checkpoint finishes the frame."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CRAYTPU_POOL_K", "1")   # paths in flight
    polls = []

    def poll(self):
        polls.append(1)
        return "x" if len(polls) == 3 else None
    monkeypatch.setattr(cli._KeyPoller, "poll", poll)
    assert cli.main(ARGS, device="cpu") == 130
    assert os.path.exists(CKPT) and not os.path.exists(PNG)
    assert checkpoint.kind(CKPT) == "persistent"
    resume, total, shape = checkpoint.load_persistent(CKPT)
    assert total == 2 and shape == (24, 32) and len(resume["pending"]) > 0
    assert cli.main(ARGS + ["--resume", CKPT], device="cpu") == 0
    assert_png_close(PNG, port_png)


def test_cli_resume_progressive(tmp_path, monkeypatch):
    """A progressive checkpoint after pass 1 of 2 resumes on the
    per-pass path and gives the uninterrupted per-pass render."""
    monkeypatch.chdir(tmp_path)
    host = load_scene_from_file(SCENE, {"width": 32, "height": 24,
                                        "samples": 2})
    r = WavefrontRenderer(compile_scene(host, "cpu"))
    acc = r.render_pass(torch.zeros((24, 32, 4)), 0, 2)
    checkpoint.save("c.npz", acc.numpy(), 1, 2)
    assert cli.main(ARGS + ["--resume", "c.npz"], device="cpu") == 0
    want = _to_srgb_u8(r.render(spp=2))[::-1]
    np.testing.assert_array_equal(read_png_rgb(PNG), want)


@pytest.mark.parametrize("kind", ["persistent", "progressive"])
def test_cli_resume_mismatch_exits(kind, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if kind == "persistent":
        checkpoint.save_persistent("c.npz", np.zeros((16, 4), np.float32),
                                   np.zeros(0, np.int64), [[0, 32]], 2,
                                   (4, 4))
    else:
        checkpoint.save("c.npz", np.zeros((4, 4, 4), np.float32), 1, 2)
    with pytest.raises(SystemExit) as e:
        cli.main(ARGS + ["--resume", "c.npz"], device="cpu")
    assert e.value.code != 0


def test_cli_preview_progressive(tmp_path, monkeypatch):
    """--preview 1 takes the per-pass path and writes a preview PNG after
    every pass."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(ARGS + ["--preview", "1"], device="cpu") == 0
    assert os.path.exists(os.path.join("output", "entry_preview.png"))
    assert read_png_rgb(PNG).shape == (24, 32, 3)


def test_cli_nee_renders(port_png, tmp_path, monkeypatch):
    """--nee renders through next-event estimation on the CPU: a PNG
    within the golden thresholds of craytpu's --nee PNG, and not the
    plain render's."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(ARGS + ["--nee"], device="cpu") == 0
    got = read_png_rgb(PNG)
    assert got.shape == (24, 32, 3)
    assert not np.array_equal(got, read_png_rgb(port_png))
    os.rename(PNG, "port_nee.png")
    assert jmain.main(ARGS + ["--nee"]) == 0
    assert_png_close("port_nee.png", PNG)


def test_help(capsys):
    assert cli.main(["-h"], device="cpu") == 0
    assert "Usage:" in capsys.readouterr().out


def test_module_entry_point_on_cpu(tmp_path):
    """python -m craytpu_torch with CRAYTPU_PLATFORM=cpu, as from a
    shell."""
    env = dict(os.environ, CRAYTPU_PLATFORM="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    res = subprocess.run(
        [sys.executable, "-m", "craytpu_torch", SCENE, "-s", "1", "-d",
         "16x12"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert read_png_rgb(str(tmp_path / PNG)).shape == (12, 16, 3)


def test_args_resume_value_not_scene(tmp_path):
    ckpt = tmp_path / "ckpt.npz"
    ckpt.write_bytes(b"x")
    scene = tmp_path / "scene.json"
    scene.write_text("{}")
    opts = cliargs.parse_args(["--resume", str(ckpt), str(scene)])
    assert opts["inputFile"] == str(scene)
    assert opts["resume"] == str(ckpt)
    # --resume before (or without) the scene must not claim the ckpt file
    opts = cliargs.parse_args(["--resume", str(ckpt)])
    assert "inputFile" not in opts


def test_args_trace_preview_values_not_scene(tmp_path):
    scene = tmp_path / "scene.json"
    scene.write_text("{}")
    tdir = tmp_path / "trc"
    tdir.mkdir()
    # --trace <existing path> before the scene: the path is the trace dir,
    # not the scene (same misparse class as --resume)
    opts = cliargs.parse_args(["--trace", str(tdir), str(scene)])
    assert opts["inputFile"] == str(scene)
    assert opts["trace_dir"] == str(tdir)
    # --preview N: the integer is the pass interval, not a scene candidate
    opts = cliargs.parse_args(["--preview", "4", str(scene)])
    assert opts["inputFile"] == str(scene)
    assert opts["preview"] == 4
    # --preview directly followed by the scene still finds the scene
    opts = cliargs.parse_args(["--preview", str(scene)])
    assert opts["inputFile"] == str(scene)
    assert opts["preview"] is True


@pytest.mark.parametrize("argv", [
    ["--resume", "c.npz", "-s", "3", "-d", "40x30", "-t", "8x8", "-j", "2",
     "--iterative", "-v", "--preview", "2", "--custom-tag"],
    ["-d", "0x5", "-t", "bad", "-s", "x", "--suite", "a", "--test", "3"]])
def test_args_match_jax_package(argv):
    """The port's parser gives craytpu's dict (and the same scene
    overrides) for the same argv."""
    from craytpu import args as jargs
    assert cliargs.parse_args(argv) == jargs.parse_args(argv)
    assert (cliargs.scene_overrides(cliargs.parse_args(argv))
            == jargs.scene_overrides(jargs.parse_args(argv)))
    assert cliargs._parse_dims("12X7") == jargs._parse_dims("12X7") == (
        12, 7)
