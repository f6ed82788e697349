"""The port's master/worker cluster (craytpu_torch/parallel/cluster.py) on
the CPU, mirroring tests/test_cluster.py: a port worker in a thread over a
socketpair, with its file IO served from the shipped in-memory cache,
renders tiles that assemble into the port's local frame. Also holds the
wire format against the JAX package's: craytpu's own master drives a port
worker, and craytpu's framing reads the port's frames byte for byte.

Tolerance: a clustered frame against the local per-pass render, rtol 2e-6
and atol 2e-7 (tests/test_cluster.py:101): the same per-(pixel, pass)
streams, summed in another order."""

import json
import socket
import threading

import numpy as np
import pytest
import torch

from craytpu.parallel import cluster as jcluster
from craytpu.version import REFERENCE_VERSION as J_REFERENCE_VERSION
from craytpu.version import __version__ as j_version
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.parallel import cluster
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.scene.sceneloader import load_scene_from_buf
from craytpu_torch.version import REFERENCE_VERSION, __version__

torch.set_num_threads(2)

# tests/test_cluster.py's scene: 2x2 tiles of 16x16 (two clipped)
SCENE = {
    "renderer": {"samples": 2, "bounces": 3, "width": 32, "height": 24,
                 "tileWidth": 16, "tileHeight": 16},
    "camera": {"FOV": 80.0, "transforms": [
        {"type": "translate", "x": 0, "y": 0, "z": -5}]},
    "scene": {
        "ambientColor": {"down": {"r": 1, "g": 1, "b": 1},
                         "up": {"r": 0.5, "g": 0.7, "b": 1.0}},
        "primitives": [
            {"type": "sphere", "radius": 1.0,
             "color": {"r": 0.9, "g": 0.1, "b": 0.1}, "bsdf": "lambertian",
             "instances": [{"transforms": [
                 {"type": "translate", "x": 0, "y": 0, "z": 0}]}]},
        ],
    },
}
TEXT = json.dumps(SCENE)


def assert_frame(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-7)


@pytest.fixture(scope="module")
def local():
    """(scene, port renderer, the local per-pass frame of 2 passes)."""
    scene = load_scene_from_buf(TEXT)
    r = WavefrontRenderer(compile_scene(scene, "cpu"))
    acc = torch.zeros((24, 32, 4))
    for p in range(2):
        acc = r.render_pass(acc, p, 2)
    return scene, r, acc.numpy()


def start_worker():
    """A port worker on the CPU in a thread: (master's socket, thread)."""
    a, b = socket.socketpair()

    def run():
        try:
            cluster.serve_connection(b, device="cpu")
        finally:
            b.close()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return a, t


def load_worker(sock, send=cluster.send_json, read=cluster.read_json,
                versions=(REFERENCE_VERSION, __version__)):
    """Handshake, assets and scene, through the given framing."""
    send(sock, {"action": "handshake", "version": versions[0],
                "framework": versions[1]})
    assert read(sock)["action"] == "handshake"
    send(sock, {"action": "loadAssets", "files": {}})
    assert read(sock)["action"] == "ok"
    send(sock, {"action": "loadScene", "scene": TEXT, "assetPath": "",
                "overrides": {}})
    ready = read(sock)
    assert ready["action"] == "ready" and ready["devices"] == 1


def test_handshake_rejects_version_mismatch():
    a, t = start_worker()
    cluster.send_json(a, {"action": "handshake", "version": "v9.9.9",
                          "framework": __version__})
    r = cluster.read_json(a)
    assert r["action"] == "error" and "version" in r["error"]
    a.close()
    t.join(timeout=10)


def test_parse_nodes():
    nodes = "10.0.0.1:2222, host2 ,h3:9999"
    assert cluster.parse_nodes(nodes) == [
        ("10.0.0.1", 2222), ("host2", cluster.DEFAULT_PORT), ("h3", 9999)]
    assert cluster.parse_nodes(nodes) == jcluster.parse_nodes(nodes)


def test_dead_worker_tiles_reclaimed():
    q = cluster.TileQueue([{"i": k} for k in range(4)])
    assert q.next_tile("w1") == 0
    assert q.next_tile("w1") == 1
    assert q.next_tile("local") == 2
    assert sorted(q.reclaim("w1")) == [0, 1]
    # reclaimed tiles go to the END of the queue (tile.c:32-41)
    assert q.next_tile("local") == 3
    assert q.next_tile("local") in (0, 1)
    assert q.next_tile("local") in (0, 1)
    assert q.next_tile("local") is None and not q.done()
    for i in range(4):
        q.submit(i)
    assert q.done()


@pytest.mark.parametrize("with_worker", [False, True])
def test_clustered_render_matches_local(local, with_worker):
    """The master alone (no clients) and a port worker alone
    (render_local=False) each give the local frame."""
    scene, r, want = local
    clients, t = [], None
    if with_worker:
        a, t = start_worker()
        load_worker(a)
        clients = [(("worker", 0), a)]
    fb = cluster.render_clustered(scene, r, clients, spp=2,
                                  render_local=not with_worker)
    if t is not None:
        # the worker waits for the next session message until the master
        # hangs up
        clients[0][1].close()
        t.join(timeout=60)
        assert not t.is_alive()
    assert fb.shape == (24, 32, 4) and fb.dtype == np.float32
    assert_frame(fb, want)


def test_worker_killed_mid_render_frame_completes(local):
    """A worker that claims a tile and dies without submitting it: the
    master reclaims the tile, renders it locally, and the frame is
    complete. Also passes the worker's stats push through on_stats."""
    scene, r, want = local
    a, b = socket.socketpair()
    claimed = []

    def dying_worker(conn):
        msg = cluster.read_json(conn)
        assert msg["action"] == "startRender"
        cluster.send_json(conn, {"action": "stats", "completed": 0,
                                 "avgPerPass": 12.5})
        cluster.send_json(conn, {"action": "getWork"})
        work = cluster.read_json(conn)
        assert work["action"] == "tile"
        claimed.append(work["tile_idx"])
        conn.close()                      # dies mid-tile

    t = threading.Thread(target=dying_worker, args=(b,), daemon=True)
    t.start()
    stats = {}
    fb = cluster.render_clustered(
        scene, r, [(("deadhost", 1), a)], spp=2, render_local=True,
        on_stats=lambda n, c, avg: stats.update({n: (c, avg)}))
    t.join(timeout=30)
    a.close()
    assert claimed, "worker never claimed a tile"
    assert stats.get("deadhost:1") == (0, 12.5)
    assert_frame(fb, want)


def test_render_tile_off_schedule_falls_back(local):
    """A master tile that is not one of the renderer's own schedule tiles
    (mismatched tile prefs) takes the trace_batch path and gives the
    local frame's pixels."""
    _, r, want = local
    t = {"begin_x": 8, "begin_y": 8, "end_x": 16, "end_y": 16}
    assert cluster._tile_gid_ranges(r, t, 2) is None
    # a schedule tile maps to one id range a pass
    t0 = {"begin_x": 0, "begin_y": 0, "end_x": 16, "end_y": 16}
    (a0, b0), (a1, b1) = cluster._tile_gid_ranges(r, t0, 2)
    assert b0 - a0 == b1 - a1 == 256 and a1 - a0 == 32 * 24
    tile = cluster.render_tile(r, t, 2, 8, 8)
    assert tile.shape == (8, 8, 4)
    assert_frame(tile, want[8:16, 8:16])


def test_jax_master_drives_port_worker(local):
    """craytpu's render_clustered (render_local=False: craytpu compiles
    nothing) over craytpu's framing and versions, against a port worker:
    the port's local frame."""
    from craytpu.scene.sceneloader import load_scene_from_buf as jload
    _, r, want = local
    assert (REFERENCE_VERSION, __version__) == (J_REFERENCE_VERSION,
                                                j_version)
    a, t = start_worker()
    load_worker(a, jcluster.send_json, jcluster.read_json,
                (J_REFERENCE_VERSION, j_version))

    class Dims:                # all craytpu's master reads of a renderer
        width, height = r.width, r.height
    fb = jcluster.render_clustered(jload(TEXT), Dims(), [(("port", 0), a)],
                                   spp=2, render_local=False)
    a.close()
    t.join(timeout=60)
    assert not t.is_alive()
    assert_frame(fb, want)


class _Wire:
    """A socket stand-in that keeps what is sent."""

    def __init__(self):
        self.buf = b""

    def sendall(self, data):
        self.buf += data


@pytest.mark.parametrize("obj", [
    {"action": "getWork"},
    {"action": "submitWork", "tile_idx": 3, "data": "AAAAAA==",
     "shape": [2, 2, 4]},
    {"action": "loadScene", "scene": TEXT, "assetPath": "/a/ü/",
     "overrides": {"width": 32, "samples": 2}}])
def test_wire_frames_match_jax(obj):
    """The port's send_json writes craytpu's bytes, and craytpu's
    read_json reads them back."""
    port, jax_side = _Wire(), _Wire()
    cluster.send_json(port, obj)
    jcluster.send_json(jax_side, obj)
    assert port.buf == jax_side.buf
    a, b = socket.socketpair()
    cluster.send_json(a, obj)
    assert jcluster.read_json(b) == obj
    jcluster.send_json(b, obj)
    assert cluster.read_json(a) == obj
    a.close()
    b.close()
