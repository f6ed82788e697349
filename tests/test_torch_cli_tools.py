"""The port's CLI flags of the cluster, the live preview, the profiler
trace and test dispatch, run on the CPU: --tcount, --ptcount and --test
build the pytest command (subprocess is replaced, so no pytest runs
inside pytest), --test-perf runs the PNG microtest, --worker serves a
master and --shutdown --nodes stops it, --nodes renders through a port
worker in a thread, --preview-http serves status.json during a render,
and --trace writes the trace JSON and the frame records.

Tolerance: the clustered PNG against the local CLI's PNG, the golden
thresholds of craytpu/utils/golden.py:26-27 on sRGB u8
(golden.compare_u8)."""

import json
import os
import socket
import subprocess
import threading
import time
import urllib.request

import pytest
import torch

from craytpu_torch import main as cli
from craytpu_torch.io.png import read_png_rgb
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.parallel import cluster
from craytpu_torch.utils import golden

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "assets", "entry_scene.json")
ARGS = [SCENE, "-s", "2", "-d", "32x24", "-t", "16x16"]
PNG = os.path.join("output", "entry_0000.png")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_worker():
    """`--worker <port>` on the CPU in a thread, once it accepts:
    (port, thread, {"rc": exit code once it returns})."""
    port, out = free_port(), {}
    t = threading.Thread(target=lambda: out.update(
        rc=cli.main(["--worker", str(port)], device="cpu")), daemon=True)
    t.start()
    for _ in range(200):
        try:
            # an empty session: the worker logs the hang-up and goes on
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return port, t, out
        except OSError:
            time.sleep(0.05)
    raise RuntimeError("the worker never listened")


def shutdown(port, t, out):
    assert cli.main(["--shutdown", "--nodes", f"127.0.0.1:{port}"],
                    device="cpu") == 0
    t.join(timeout=30)
    assert not t.is_alive() and out["rc"] == 0


class _Ran:
    """subprocess.run / subprocess.call stand-in that keeps the command."""

    def __init__(self, stdout=""):
        self.cmds, self.stdout = [], stdout

    def run(self, cmd, **kw):
        self.cmds.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, self.stdout, "")

    def call(self, cmd, **kw):
        self.cmds.append(cmd)
        return 0


def port_test_files(cmd):
    return [os.path.basename(a) for a in cmd if a.endswith(".py")]


@pytest.mark.parametrize("flag,listing", [
    ("--tcount", "tests/test_torch_a.py::t1\ntests/test_torch_a.py::t2[x]\n"
                 "tests/test_torch_b.py::t3\n\n3 tests collected\n"),
    ("--ptcount", "tests/test_torch_a.py: 2\ntests/test_torch_b.py: 1\n")])
def test_count_flags_collect_port_tests(flag, listing, monkeypatch, capsys):
    """The count of either listing pytest prints (-q, and -qq, which -q
    with the repository's -q addopts gives)."""
    ran = _Ran(listing)
    monkeypatch.setattr(subprocess, "run", ran.run)
    assert cli.main([flag, "--suite", "cluster"], device="cpu") == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "3"
    (cmd,) = ran.cmds
    assert cmd[1:5] == ["-m", "pytest", "-q", "--collect-only"]
    files = port_test_files(cmd)
    assert "test_torch_cli_tools.py" in files and all(
        f.startswith("test_torch_") for f in files)
    assert cmd[-2:] == ["-k", "cluster"] and "--noconftest" not in cmd


def test_test_runs_port_tests(monkeypatch):
    ran = _Ran()
    monkeypatch.setattr(subprocess, "call", ran.call)
    assert cli.main(["--test"], device="cpu") == 0
    (cmd,) = ran.cmds
    assert cmd[1:4] == ["-m", "pytest", "-q"] and "-k" not in cmd
    assert "test_torch_kernels.py" in port_test_files(cmd)


def test_test_without_jax_runs_jax_free_files(monkeypatch, capsys):
    """Where jax cannot be imported, --test runs the port files that
    import no jax, without the jax conftest, and logs the files it leaves
    out."""
    import importlib.util
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "jax"
                        else find_spec(name, *a))
    ran = _Ran()
    monkeypatch.setattr(subprocess, "call", ran.call)
    assert cli.main(["--test"], device="cpu") == 0
    (cmd,) = ran.cmds
    files = port_test_files(cmd)
    assert "--noconftest" in cmd
    assert "test_torch_kernels.py" in files
    assert "test_torch_cluster.py" not in files   # imports craytpu
    assert "leaving out" in capsys.readouterr().out


def test_test_perf_suite(capsys):
    assert cli.main(["--test-perf", "--suite", "png"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "[perf] png::encode-256" in out and "bvh::" not in out


def test_worker_handshakes_a_master():
    port, t, out = start_worker()
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    cluster.send_json(s, {"action": "handshake",
                          "version": cluster.REFERENCE_VERSION,
                          "framework": cluster.__version__})
    assert cluster.read_json(s)["action"] == "handshake"
    s.close()
    shutdown(port, t, out)


def test_shutdown_nodes_stops_the_worker():
    shutdown(*start_worker())


def test_nodes_renders_through_a_worker(tmp_path, monkeypatch):
    """--nodes: the master ships the scene to a port worker, both render
    tiles, and the PNG is the local CLI's within the golden thresholds."""
    monkeypatch.chdir(tmp_path)
    port, t, out = start_worker()
    main_thread = threading.current_thread()
    by_worker = []
    render_tile = cluster.render_tile

    def counted(*a):
        if threading.current_thread() is main_thread:
            time.sleep(0.3)      # leave the worker a share of the 4 tiles
        else:
            by_worker.append(1)
        return render_tile(*a)
    monkeypatch.setattr(cluster, "render_tile", counted)
    assert cli.main(ARGS + ["--nodes", f"127.0.0.1:{port}"],
                    device="cpu") == 0
    shutdown(port, t, out)
    assert by_worker
    os.rename(PNG, "clustered.png")
    assert cli.main(ARGS, device="cpu") == 0
    ok, within, mean_abs = golden.compare_u8(read_png_rgb("clustered.png"),
                                             read_png_rgb(PNG))
    assert ok, (within, mean_abs)


def test_preview_http_serves_status(tmp_path, monkeypatch):
    """--preview-http <port>: status.json is served, with the frame's
    version and the region grid, while the persistent frame renders."""
    monkeypatch.chdir(tmp_path)
    port = free_port()
    seen = []
    render_persistent = WavefrontRenderer.render_persistent

    def wrapped(self, *a, on_frame=None, **kw):
        def hook(final, done):
            on_frame(final, done)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/status.json", timeout=5) as r:
                seen.append(json.loads(r.read()))
        return render_persistent(self, *a, on_frame=hook, **kw)
    monkeypatch.setattr(WavefrontRenderer, "render_persistent", wrapped)
    assert cli.main(ARGS + ["--preview-http", str(port)], device="cpu") == 0
    assert seen and seen[0]["version"] >= 1 and seen[0]["total"] == 1536
    assert len(seen[0]["regions"]) == 10
    assert read_png_rgb(PNG).shape == (24, 32, 3)


def test_trace_writes_chrome_json(tmp_path, monkeypatch, capsys):
    """--trace on one sphere (the CPU's plain BVH walk of a mesh makes a
    trace of millions of events): the chrome trace and the frame
    records; with CRAYTPU_TRACE=1 the CLI prints each frame's record."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CRAYTPU_TRACE", "1")
    scene = {
        "renderer": {"samples": 1, "bounces": 4, "width": 16, "height": 12,
                     "outputFilePath": "output/", "outputFileName": "ball",
                     "fileType": "png"},
        "camera": {"FOV": 70.0, "transforms": [
            {"type": "translate", "x": 0, "y": 0, "z": -4}]},
        "scene": {"primitives": [
            {"type": "sphere", "radius": 1.2, "bsdf": "lambertian",
             "color": {"r": 0.7, "g": 0.3, "b": 0.2},
             "instances": [{"transforms": [
                 {"type": "translate", "x": 0, "y": 0, "z": 0}]}]}]}}
    with open("ball.json", "w") as f:
        json.dump(scene, f)
    assert cli.main(["ball.json", "--trace", "trc"], device="cpu") == 0
    with open(os.path.join("trc", "ball_trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    # the program's own spans sit in the profiler's trace, and the frame's
    # record and the set-up spans beside it
    assert {"frame", "pool_step", "fetch"} <= {e.get("name")
                                               for e in events}
    with open(os.path.join("trc", "ball_frames.json")) as f:
        rec = json.load(f)
    assert [r["profiled"] for r in rec["frames"]] == [True]
    assert rec["frames"][0]["counts"]["steps"] > 0
    assert {"scene.load", "scene.compile"} <= {
        s["name"] for s in rec["process"]}
    err = capsys.readouterr().err
    assert "frame 1:" in err and "device ms: pool" in err
    assert read_png_rgb(os.path.join("output", "ball_0000.png")).shape == (
        12, 16, 3)
