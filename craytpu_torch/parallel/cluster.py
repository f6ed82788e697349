"""Distributed master/worker rendering (utils/protocol/* re-designed):
the JAX package's parallel/cluster.py on the port's renderer.

The reference clusters over TCP with JSON messages and base64 payloads
(protocol.c/server.c/worker.c; framing networking.c:40-42). We keep its
*control plane* — version handshake, in-band asset shipping (workers need
zero local files), pull-based tile queue, dead-worker tile reclaim — and
replace the compute with the wavefront renderer on the worker's card.
Pixel payloads are float32 RGBA (the master keeps compositing in linear
space), length-prefixed JSON framing instead of 1024-byte chunks. The
wire format is the JAX package's byte for byte (same versions in the
handshake), so either package's master drives either package's worker.

Worker protocol (worker.c:43-48): handshake -> loadAssets -> loadScene ->
startRender{ getWork / submitWork ... } -> goodbye.

Workers and the master's local share render on the CUDA card unless the
caller passes device="cpu" (the CLI does under CRAYTPU_PLATFORM=cpu).
"""

from __future__ import annotations

import base64
import json
import os
import socket
import struct
import threading
import time

import numpy as np

from craytpu_torch.utils import fileio
from craytpu_torch.utils import logging
from craytpu_torch.version import __version__, REFERENCE_VERSION

DEFAULT_PORT = 2222  # protocol.h:14
_LEN = struct.Struct(">Q")  # 8-byte big-endian length header


# ---------------------------------------------------------------------------
# framing (networking.c chunkedSend/chunkedReceive equivalent)
# ---------------------------------------------------------------------------

def send_json(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode("utf-8")
    sock.sendall(_LEN.pack(len(data)) + data)


def read_json(sock: socket.socket) -> dict | None:
    hdr = _read_exact(sock, _LEN.size)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    if n > (1 << 33):
        raise ValueError(f"oversized message ({n} bytes)")
    data = _read_exact(sock, n)
    return None if data is None else json.loads(data.decode("utf-8"))


def _read_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


# ---------------------------------------------------------------------------
# tile work units
# ---------------------------------------------------------------------------

def _tile_xy(tile_dict, tile_w, tile_h, width):
    """Full-size (tile_h, tile_w) pixel grid for a (possibly edge-clipped)
    tile: every tile traces a batch of the same shape."""
    bx, by = tile_dict["begin_x"], tile_dict["begin_y"]
    ys, xs = np.mgrid[by:by + tile_h, bx:bx + tile_w]
    return xs.reshape(-1).astype(np.int32), ys.reshape(-1).astype(np.int32)


def render_tile(renderer, tile_dict, spp, tile_w, tile_h):
    """Render every sample of one tile -> (h, w, 4) float32.

    Same per-(pixel, pass) streams as a whole-frame render, so tile-based
    cluster renders match local ones up to float accumulation order.

    A renderer with render_ids (the sharded persistent-pool renderer,
    not ported yet; it returns the frame's radiance sum on the host)
    maps the tile to its contiguous ranges of the tile-order pixel
    schedule, one per pass, and renders them as one pool. The
    single-card renderer traces the tile's full-size pixel grid
    once a pass (trace_batch), sums the passes in order and divides by
    spp as a float32 tensor (a division by a Python float on CUDA is a
    multiply by the reciprocal)."""
    import torch
    if hasattr(renderer, "render_ids"):
        ranges = _tile_gid_ranges(renderer, tile_dict, spp)
        if ranges is not None:
            H, W = renderer.height, renderer.width
            fb = renderer.render_ids(ranges, spp) / np.float32(spp)
            fb = fb.reshape(H, W, 4)
            return np.ascontiguousarray(
                fb[tile_dict["begin_y"]:tile_dict["end_y"],
                   tile_dict["begin_x"]:tile_dict["end_x"]])
    dev = renderer.device
    xs, ys = _tile_xy(tile_dict, tile_w, tile_h, renderer.width)
    xs = torch.from_numpy(xs).to(dev)
    ys = torch.from_numpy(ys).to(dev)
    acc = torch.zeros((xs.shape[0], 4), dtype=torch.float32, device=dev)
    for p in range(spp):
        acc = acc + renderer.trace_batch(xs, ys, p, spp)
    acc = (acc / acc.new_tensor(float(spp))).cpu().numpy()
    acc = acc.reshape(tile_h, tile_w, 4)
    return acc[:tile_dict["end_y"] - tile_dict["begin_y"],
               :tile_dict["end_x"] - tile_dict["begin_x"]]


def _tile_gid_ranges(renderer, tile_dict, spp):
    """Map a master tile to this renderer's pixel-schedule id ranges
    (gid = pass * npix + sched_index), one contiguous range per pass —
    or None when the tile doesn't align with a whole schedule tile
    (mismatched tile prefs between master and worker)."""
    from craytpu_torch.runtime.tile import pixel_order
    p = renderer.cscene.prefs
    npix = renderer.width * renderer.height
    _, _, tiles, offsets = pixel_order(renderer.width, renderer.height,
                                       p.tile_width, p.tile_height,
                                       p.tile_order)
    for k, t in enumerate(tiles):
        if (t.begin_x == tile_dict["begin_x"]
                and t.begin_y == tile_dict["begin_y"]
                and t.end_x == tile_dict["end_x"]
                and t.end_y == tile_dict["end_y"]):
            off, cnt = int(offsets[k]), int(offsets[k + 1] - offsets[k])
            return [[p * npix + off, p * npix + off + cnt]
                    for p in range(spp)]
    return None


class TileQueue:
    """Mutex-guarded work queue with dead-worker reclaim (tile.c:22-45)."""

    def __init__(self, tiles):
        self._lock = threading.Lock()
        self._pending = list(range(len(tiles)))
        self._in_flight: dict[int, str] = {}
        self.tiles = tiles
        self.completed = 0

    def next_tile(self, owner: str):
        with self._lock:
            if not self._pending:
                return None
            idx = self._pending.pop(0)
            self._in_flight[idx] = owner
            return idx

    def submit(self, idx: int):
        with self._lock:
            self._in_flight.pop(idx, None)
            self.completed += 1

    def reclaim(self, owner: str):
        """Requeue tiles owned by a dead worker (tile.c:32-41)."""
        with self._lock:
            dead = [i for i, o in self._in_flight.items() if o == owner]
            for i in dead:
                del self._in_flight[i]
            self._pending.extend(dead)  # end of the queue, like tile.c:32-41
            return dead

    def done(self):
        with self._lock:
            return not self._pending and not self._in_flight


# ---------------------------------------------------------------------------
# worker (utils/protocol/worker.c)
# ---------------------------------------------------------------------------

def _worker_build_renderer(scene_text, overrides, asset_path, device=None):
    """Worker-side renderer: the scene from the shipped text and assets,
    compiled on `device` (None = the CUDA card), and the product's
    renderer factory over it (worker.c:221-289 renders a tile job with
    its full local pool)."""
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_buf
    scene = load_scene_from_buf(scene_text, asset_path, overrides or {})
    return scene, make_renderer(compile_scene(scene, device))


def _local_device_count(renderer) -> int:
    """Devices the worker renders on, reported in its ready message."""
    import torch
    if renderer.device.type == "cuda":
        return torch.cuda.device_count()
    return 1


def serve_connection(conn: socket.socket, device=None) -> bool:
    """Handle one master session, rendering on `device` (None = the CUDA
    card). Returns False on a shutdown request."""
    scene = renderer = None
    while True:
        msg = read_json(conn)
        if msg is None:
            logging.info("Master disconnected")
            return True
        action = msg.get("action")
        if action == "handshake":
            # version + framework check (worker.c:61-67)
            if msg.get("version") != REFERENCE_VERSION or \
                    msg.get("framework") != __version__:
                send_json(conn, {"action": "error",
                                 "error": "version mismatch"})
                return True
            send_json(conn, {"action": "handshake",
                             "threads": os.cpu_count() or 1})
        elif action == "shutdown":
            send_json(conn, {"action": "goodbye"})
            return False
        elif action == "loadAssets":
            fileio.set_worker_cache(fileio.decode_cache(msg.get("files", {})))
            send_json(conn, {"action": "ok"})
        elif action == "loadScene":
            scene, renderer = _worker_build_renderer(
                msg["scene"], msg.get("overrides"), msg.get("assetPath", ""),
                device)
            send_json(conn, {"action": "ready",
                             "threads": os.cpu_count() or 1,
                             "devices": _local_device_count(renderer)})
        elif action == "startRender":
            spp = int(msg.get("spp") or scene.prefs.sample_count)
            tw, th = scene.prefs.tile_width, scene.prefs.tile_height
            tw = min(tw, renderer.width)
            th = min(th, renderer.height)
            completed = 0
            avg_ms = 0.0
            last_stats = time.monotonic()
            while True:
                # ~1 Hz in-band stats push (worker.c:259-272): completed
                # tiles + average per-tile wall time; the master records
                # it without replying
                now = time.monotonic()
                if now - last_stats >= 1.0:
                    send_json(conn, {"action": "stats",
                                     "completed": completed,
                                     "avgPerPass": avg_ms})
                    last_stats = now
                send_json(conn, {"action": "getWork"})
                work = read_json(conn)
                if work is None or work.get("action") == "finish":
                    break
                t = work["tile"]
                t0 = time.monotonic()
                buf = render_tile(renderer, t, spp, tw, th)
                dt_ms = (time.monotonic() - t0) * 1e3
                completed += 1
                avg_ms += (dt_ms - avg_ms) / completed
                send_json(conn, {
                    "action": "submitWork", "tile_idx": work["tile_idx"],
                    "data": base64.b64encode(
                        buf.astype("<f4").tobytes()).decode("ascii"),
                    "shape": list(buf.shape)})
            send_json(conn, {"action": "goodbye"})
            fileio.set_worker_cache(None)
        else:
            send_json(conn, {"action": "error",
                             "error": f"unknown action {action!r}"})


def start_worker(port: int = DEFAULT_PORT, max_sessions: int | None = None,
                 device=None) -> int:
    """startWorkerServer (worker.c:348-438): accept masters in a loop,
    rendering on `device` (None = the CUDA card)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("0.0.0.0", port))
    srv.listen(1)
    logging.info("Worker listening on :%d", port)
    sessions = 0
    while max_sessions is None or sessions < max_sessions:
        conn, addr = srv.accept()
        logging.info("Master connected: %s", addr)
        try:
            keep_going = serve_connection(conn, device)
        except Exception as e:  # stay alive for the next master
            logging.warning("Session error: %s", e)
            keep_going = True
        finally:
            conn.close()
        sessions += 1
        if not keep_going:
            break
    srv.close()
    return 0


# ---------------------------------------------------------------------------
# master (utils/protocol/server.c)
# ---------------------------------------------------------------------------

def parse_nodes(nodes_list: str):
    """buildClientList address parsing (server.c:105-124)."""
    out = []
    for item in nodes_list.split(","):
        item = item.strip()
        if not item:
            continue
        host, _, port = item.partition(":")
        out.append((host, int(port) if port else DEFAULT_PORT))
    return out


def _connect(addr, timeout=2.0):
    try:
        s = socket.create_connection(addr, timeout=timeout)
        s.settimeout(None)
        return s
    except OSError:
        return None


def shutdown_workers(nodes_list: str) -> None:
    """--shutdown --nodes (server.c:353-367)."""
    for addr in parse_nodes(nodes_list):
        s = _connect(addr)
        if s is None:
            logging.warning("Node %s:%d unreachable", *addr)
            continue
        send_json(s, {"action": "shutdown"})
        read_json(s)
        s.close()
        logging.info("Shut down %s:%d", *addr)


def sync_with_clients(nodes_list: str, scene_text: str, asset_path: str,
                      assets: dict[str, bytes], overrides: dict):
    """syncWithClients (server.c:369-410): handshake + ship assets + scene.
    Returns live sockets; unreachable/mismatched nodes are pruned."""
    clients = []
    for addr in parse_nodes(nodes_list):
        s = _connect(addr)
        if s is None:
            logging.warning("Failed to connect to %s:%d, dropping", *addr)
            continue
        send_json(s, {"action": "handshake", "version": REFERENCE_VERSION,
                      "framework": __version__})
        r = read_json(s)
        if not r or r.get("action") != "handshake":
            logging.warning("Handshake rejected by %s:%d: %s", addr[0],
                            addr[1], r)
            s.close()
            continue
        send_json(s, {"action": "loadAssets",
                      "files": fileio.encode_cache(assets)})
        read_json(s)
        send_json(s, {"action": "loadScene", "scene": scene_text,
                      "assetPath": asset_path, "overrides": overrides})
        r = read_json(s)
        if not r or r.get("action") != "ready":
            logging.warning("Node %s:%d failed to load scene: %s", addr[0],
                            addr[1], r)
            s.close()
            continue
        logging.info("Worker %s:%d ready (%s devices, %s threads)",
                     addr[0], addr[1], r.get("devices", 1),
                     r.get("threads"))
        clients.append((addr, s))
    return clients


def render_clustered(scene, renderer, clients, spp: int | None = None,
                     render_local: bool = True, progress=None,
                     on_stats=None) -> np.ndarray:
    """renderFrame with networkRenderThreads (renderer.c:96-180).

    One serving thread per worker + (optionally) local rendering in this
    thread, all pulling from one TileQueue. Returns the (H, W, 4) float
    framebuffer (linear, y-up). on_stats(worker_name, completed, avg_ms)
    receives each worker's ~1 Hz stats push (server.c:240-244)."""
    from craytpu_torch.runtime.tile import quantize_image
    p = scene.prefs
    spp = spp or p.sample_count
    W, H = renderer.width, renderer.height
    tw, th = min(p.tile_width, W), min(p.tile_height, H)
    tiles = quantize_image(W, H, tw, th, p.tile_order)
    tdicts = [{"begin_x": t.begin_x, "begin_y": t.begin_y,
               "end_x": t.end_x, "end_y": t.end_y} for t in tiles]
    queue = TileQueue(tdicts)
    fb = np.zeros((H, W, 4), np.float32)
    fb_lock = threading.Lock()

    def place(idx, buf):
        t = tdicts[idx]
        with fb_lock:
            fb[t["begin_y"]:t["end_y"], t["begin_x"]:t["end_x"]] = buf
        queue.submit(idx)
        if progress is not None:
            progress(queue.completed, len(tiles))

    def serve(addr, sock):
        name = f"{addr[0]}:{addr[1]}"
        try:
            send_json(sock, {"action": "startRender", "spp": spp})
            while True:
                msg = read_json(sock)
                if msg is None:
                    raise OSError("connection lost")
                act = msg.get("action")
                if act == "getWork":
                    idx = queue.next_tile(name)
                    if idx is None:
                        send_json(sock, {"action": "finish"})
                    else:
                        send_json(sock, {"action": "tile", "tile_idx": idx,
                                         "tile": tdicts[idx]})
                elif act == "submitWork":
                    buf = np.frombuffer(
                        base64.b64decode(msg["data"]), "<f4").reshape(
                            msg["shape"]).copy()
                    place(msg["tile_idx"], buf)
                elif act == "stats":
                    if on_stats is not None:
                        on_stats(name, int(msg.get("completed", 0)),
                                 float(msg.get("avgPerPass", 0.0)))
                elif act == "goodbye":
                    return
        except (OSError, ValueError) as e:
            dead = queue.reclaim(name)
            logging.warning("Worker %s died (%s); reclaimed %d tiles", name,
                            e, len(dead))

    threads = [threading.Thread(target=serve, args=c, daemon=True)
               for c in clients]
    for t in threads:
        t.start()

    if render_local or not clients:
        while True:
            idx = queue.next_tile("local")
            if idx is None:
                break
            place(idx, render_tile(renderer, tdicts[idx], spp, tw, th))
    for t in threads:
        t.join()
    # any tiles reclaimed from dead workers after local finished
    while not queue.done():
        idx = queue.next_tile("local")
        if idx is None:
            time.sleep(0.05)
            continue
        place(idx, render_tile(renderer, tdicts[idx], spp, tw, th))
    return fb
