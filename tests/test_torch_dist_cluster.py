"""The port's cluster worker and master as groups of ranks
(craytpu_torch/parallel/cluster.py over torch.distributed) on the CPU,
mirroring tests/test_cluster.py:164-215: craytpu's master drives a 2-rank
port worker, and a 2-rank port master renders its local tiles through
ShardedPoolRenderer.render_ids; both frames against the port's per-pass
render of tests/test_cluster.py's scene (32x24, 16x16 tiles, 2 spp).

The port's ranks are gloo groups started with dist.spawn_local (one
thread of torch each; bodies in tests/torch_dist_ranks.py, which imports
neither jax nor craytpu). Tolerance: rtol 2e-5, atol 2e-6
(tests/test_cluster.py:197: the pool's sums run in another order than
the per-pass render's)."""

import errno
import socket
import threading
import time

import numpy as np
import pytest
import torch

from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.parallel import dist
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.scene.sceneloader import load_scene_from_buf
from tests import torch_dist_ranks as ranks

RTOL, ATOL = 2e-5, 2e-6


def listening(port: int) -> bool:
    """True once something is bound to `port` (probed by binding, not by
    connecting: a connection would be a master session)."""
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", port))
    except OSError as e:
        return e.errno == errno.EADDRINUSE
    finally:
        s.close()
    return False


@pytest.fixture(scope="module")
def runs():
    """A 2-rank port worker driven by craytpu's master, and a 2-rank port
    master alone, at once; the port's per-pass frame meanwhile."""
    from craytpu.parallel import cluster as jcluster
    from craytpu.scene.sceneloader import load_scene_from_buf as jload
    from tests.test_torch_cluster import SCENE, TEXT
    SPP = SCENE["renderer"]["samples"]
    out: dict = {}
    port = dist.free_port()

    def run(name, *a):
        out[name] = dist.spawn_local(2, *a, device="cpu", threads=1,
                                     timeout_s=240,
                                     collective_timeout_s=200)
    threads = [threading.Thread(target=run, daemon=True,
                                args=("worker", ranks.cluster_worker, port)),
               threading.Thread(target=run, daemon=True,
                                args=("master", ranks.cluster_master, TEXT,
                                      SPP))]
    for t in threads:
        t.start()
    torch.set_num_threads(2)
    r = WavefrontRenderer(compile_scene(load_scene_from_buf(TEXT), "cpu"))
    acc = torch.zeros((r.height, r.width, 4))
    for p in range(SPP):
        acc = r.render_pass(acc, p, SPP)
    out["local"] = acc.numpy()

    deadline = time.monotonic() + 120
    while not listening(port):
        assert time.monotonic() < deadline, "the port worker never listened"
        time.sleep(0.1)
    jscene = jload(TEXT)
    clients = jcluster.sync_with_clients(f"127.0.0.1:{port}", TEXT, "", {},
                                         {})
    out["ready"] = len(clients)
    # craytpu's master with no local share: every tile from the worker
    # (its renderer argument only gives the frame's size)
    out["from_worker"] = jcluster.render_clustered(
        jscene, r, clients, spp=SPP, render_local=False)
    for _, sock in clients:
        sock.close()                         # ends the worker's session
    for t in threads:
        t.join(timeout=300)
    assert {"worker", "master"} <= set(out)
    return out


def test_jax_master_drives_two_rank_port_worker(runs):
    assert runs["ready"] == 1
    assert runs["worker"] == [0, 0]          # both ranks ended cleanly
    np.testing.assert_allclose(runs["from_worker"], runs["local"],
                               rtol=RTOL, atol=ATOL)


def test_two_rank_port_master_renders_local_tiles(runs):
    ranks0, ranks1 = runs["master"]
    assert ranks0["class"] == ranks1["class"] == "ShardedPoolRenderer"
    assert ranks0["devices"] == 1            # two ranks on one CPU
    np.testing.assert_allclose(ranks0["frame"], runs["local"], rtol=RTOL,
                               atol=ATOL)
