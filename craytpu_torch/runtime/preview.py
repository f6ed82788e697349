"""Live render preview over localhost HTTP — the headless analogue of
the reference's SDL window (utils/ui.c:88-160 window, :236-320 tile
overlays/progress). A browser pointed at the printed URL shows the
accumulating framebuffer refreshing in place plus the live counters the
reference draws in its status line (percent, paths/s, ETA).

The JAX package's runtime/preview.py with the same page, endpoints and
status JSON; the frame is encoded by the port's standard-library PNG
writer (io/png.py::encode_png), not PIL. Runs as a daemon thread, so the
render loop only pays a host copy per update."""

from __future__ import annotations

import json
import threading
import time

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>craytpu live render</title><style>
body {{ background:#181818; color:#ddd; font:14px monospace; margin:16px }}
img {{ image-rendering:pixelated; border:1px solid #444; max-width:100%% }}
#bar {{ background:#333; height:8px; width:{w}px; max-width:100%% }}
#fill {{ background:#6c6; height:8px; width:0 }}
#wrap {{ position:relative; display:inline-block }}
#grid {{ position:absolute; left:0; top:0; pointer-events:none }}
</style></head><body>
<div id="status">waiting for first frame…</div>
<div id="bar"><div id="fill"></div></div><br>
<div id="wrap">
<img id="frame" width="{w}" height="{h}">
<canvas id="grid" width="{w}" height="{h}"></canvas>
</div>
<script>
// per-region overlay: darken unfinished cells, outline in-flight ones
// (the reference's tile overlays + per-tile progress, ui.c:236-320)
function drawRegions(s) {{
  const cv = document.getElementById('grid');
  const ctx = cv.getContext('2d');
  ctx.clearRect(0, 0, cv.width, cv.height);
  if (!s.regions) return;
  const gh = s.regions.length, gw = s.regions[0].length;
  const cw = cv.width / gw, ch = cv.height / gh;
  for (let y = 0; y < gh; ++y) for (let x = 0; x < gw; ++x) {{
    const f = s.regions[y][x];
    if (f < 0.999) {{
      ctx.fillStyle = `rgba(0,0,0,${{0.55 * (1 - f)}})`;
      ctx.fillRect(x * cw, y * ch, cw, ch);
    }}
    if (s.inflight && s.inflight[y][x]) {{
      ctx.strokeStyle = 'rgba(120,220,120,0.9)';
      ctx.lineWidth = 1;
      ctx.strokeRect(x * cw + 1, y * ch + 1, cw - 2, ch - 2);
    }}
  }}
}}
async function tick() {{
  try {{
    const s = await (await fetch('status.json')).json();
    document.getElementById('status').textContent =
      `${{(100*s.done/Math.max(s.total,1)).toFixed(1)}}% — ` +
      `${{(s.rate/1e6).toFixed(2)}} Mpaths/s — ETA ${{s.eta}} — ` +
      `v${{s.version}}`;
    document.getElementById('fill').style.width =
      (100*s.done/Math.max(s.total,1)) + '%%';
    drawRegions(s);
    const img = document.getElementById('frame');
    img.src = 'frame.png?v=' + s.version;
  }} catch (e) {{}}
  setTimeout(tick, 1000);
}}
tick();
</script></body></html>"""


class PreviewServer:
    """Serves /, /frame.png, /status.json on localhost.

    update(framebuffer, done, total) is called from the render loop's
    progress hooks; the PNG is (re-)encoded lazily on request."""

    def __init__(self, width: int, height: int, port: int = 8650):
        self.width = width
        self.height = height
        self.port = port
        self._lock = threading.Lock()
        self._fb = np.zeros((height, width, 4), np.float32)
        self._png: bytes | None = None
        self._version = 0
        self._png_version = -1
        self._done = 0
        self._total = 1
        self._regions = None
        self._inflight = None
        self._t0 = time.perf_counter()
        self._httpd = None

    # -- render-side API -------------------------------------------------
    def update(self, framebuffer: np.ndarray, done: int, total: int):
        with self._lock:
            self._fb = np.asarray(framebuffer)
            self._done = int(done)
            self._total = int(total)
            self._version += 1

    def progress_only(self, done: int, total: int):
        with self._lock:
            self._done = int(done)
            self._total = int(total)

    def update_regions(self, done_frac, inflight):
        """Per-cell progress grid (runtime.regions.RegionTracker
        snapshot): done_frac (gh, gw) f32, inflight (gh, gw) bool."""
        with self._lock:
            self._regions = np.asarray(done_frac, np.float32)
            self._inflight = np.asarray(inflight, bool)

    # -- server ----------------------------------------------------------
    def start(self) -> str:
        import http.server

        srv = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):            # silence request spam
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path == "/":
                        page = _PAGE.format(w=srv.width, h=srv.height)
                        self._send(200, "text/html", page.encode())
                    elif path == "/frame.png":
                        self._send(200, "image/png", srv._frame_png())
                    elif path == "/status.json":
                        self._send(200, "application/json",
                                   srv._status().encode())
                    else:
                        self._send(404, "text/plain", b"not found")
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return f"http://127.0.0.1:{self.port}/"

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None

    # -- encoding --------------------------------------------------------
    def _frame_png(self) -> bytes:
        with self._lock:
            if self._png_version == self._version and self._png:
                return self._png
            fb = self._fb
            version = self._version
        from craytpu_torch.io.png import _to_srgb_u8, encode_png
        png = encode_png(_to_srgb_u8(fb)[::-1])
        with self._lock:
            self._png = png
            self._png_version = version
            return self._png

    def _status(self) -> str:
        with self._lock:
            done, total, version = self._done, self._total, self._version
            regions = self._regions
            inflight = self._inflight
        elapsed = time.perf_counter() - self._t0
        rate = done / elapsed if elapsed > 0 else 0.0
        eta = "?"
        if 0 < done < total and rate > 0:
            from craytpu_torch.utils.logging import smart_time
            eta = smart_time((total - done) / rate * 1e3)
        out = {"done": done, "total": total, "rate": rate,
               "eta": eta, "version": version, "elapsed": elapsed}
        if regions is not None:
            out["regions"] = np.round(regions, 4).tolist()
            out["inflight"] = inflight.astype(int).tolist()
        return json.dumps(out)


def frame_hook(srv: PreviewServer | None, renderer, spp: int,
               every_s: float = 2.0):
    """render_persistent's on_frame(final_sum, done) callback that feeds
    `srv`: the running mean of the completed paths, fetched to the host at
    most once every `every_s` seconds (the fetch is a full device-to-host
    copy, 33 MB at 1080p).

    A renderer over a group of ranks (parallel/pool_shard.py) sums the
    ranks' partials in each fetch, a collective, so every rank calls the
    hook (srv is None but on rank 0) and the ranks fetch at the same
    refills: after each sixteenth of the frame's paths, not on a clock."""
    npix = renderer.width * renderer.height
    last = [0.0]
    group = getattr(renderer, "n_ranks", 1) > 1
    mark = [0]

    def on_frame(final_dev, done):
        if group:
            if done * 16 < (mark[0] + 1) * npix * spp:
                return
            mark[0] = done * 16 // (npix * spp)
        else:
            now = time.perf_counter()
            if now - last[0] < every_s or done <= 0:
                return
            last[0] = now
        fs = renderer.fetch_partial(final_dev)
        if srv is None:
            return
        denom = max(done / npix, 1e-9)
        srv.update((fs / denom).reshape(renderer.height, renderer.width, 4),
                   done, npix * spp)
    return on_frame
