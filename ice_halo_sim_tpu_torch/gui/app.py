"""Live-view web GUI: Server-backed image polling + display-time controls.

The port's copy of the JAX package's gui/app.py, over the port's Server
(CUDA by default: ``serve(..., device="cuda")``, ``--device``).

Endpoints (all served by stdlib http.server, no dependencies):
  GET  /                    the viewer page (embedded HTML/JS)
  GET  /frame/<r>.png?ev=F  render r tone-mapped with an EV offset applied
                            DISPLAY-time (re-runs post_process on the raw
                            XYZ — the reference GUI's adaptive-brightness
                            path, doc/adaptive-brightness.md; accumulation
                            is untouched)
  GET  /status              JSON: ray count, state, generation, idle flag,
                            per-render ev_auto suggestions
  POST /commit              body = project JSON; returns {"reused": bool}
                            (value-equal layouts keep the accumulation —
                            the reference's CommitConfig reuse predicate)
  GET  /project             the ACTIVE project as JSON (save; with /commit
                            this round-trips a project file — the web
                            analog of the reference GUI's .lmc save/load,
                            src/gui/file_io.cpp)
  GET  /crystal/<id>.json   triangle mesh {vertices, triangles} of crystal
                            <id> at its distribution centers (the 3D
                            preview data path; reference
                            src/gui/crystal_renderer.cpp renders the same
                            mesh through an FBO)

The simulation pumps in the Server's own thread; HTTP handlers only read
immutable ResultFrame snapshots or issue commits, the same contract the
reference's GUI poller thread follows (src/gui/server_poller.cpp).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>ice_halo_sim_tpu_torch</title><style>
body { background: #14161a; color: #cfd3da; font: 14px system-ui; margin: 1.2em; }
img  { image-rendering: auto; max-width: 95vw; border: 1px solid #333; }
.bar { margin: 0.6em 0; display: flex; gap: 1.2em; align-items: center; }
input[type=range] { width: 260px; }
code { color: #8fd3ff; }
</style></head><body>
<h3>ice_halo_sim_tpu_torch &mdash; live view</h3>
<div class="bar">
  <label>render <select id="render"></select></label>
  <label>EV <input type="range" id="ev" min="-6" max="6" step="0.1" value="0">
        <span id="evv">0.0</span></label>
  <button id="evauto">EV auto</button>
  <button id="save">save project</button>
  <button id="loadbtn">load project</button>
  <input type="file" id="load" style="display:none" accept=".json">
  <span id="stat"></span>
</div>
<div style="display:flex; gap:1em; align-items:flex-start">
<img id="img" src="/frame/0.png">
<div><label>crystal <select id="crys"></select></label><br>
<canvas id="xtal" width="200" height="200" style="border:1px solid #333"></canvas></div>
</div>
<script>
const img = document.getElementById('img');
const sel = document.getElementById('render');
const ev = document.getElementById('ev');
const evv = document.getElementById('evv');
let evAuto = [];
function refresh() {
  const r = sel.value || 0;
  img.src = `/frame/${r}.png?ev=${ev.value}&t=${Date.now()}`;
}
ev.oninput = () => { evv.textContent = (+ev.value).toFixed(1); refresh(); };
sel.onchange = refresh;
document.getElementById('evauto').onclick = () => {
  const r = sel.value || 0;
  if (evAuto.length > r) { ev.value = evAuto[r]; ev.oninput(); }
};
async function poll() {
  try {
    const s = await (await fetch('/status')).json();
    evAuto = s.ev_auto;
    document.getElementById('stat').textContent =
      `${s.ray_count.toLocaleString()} rays | ${s.state}` +
      (s.is_idle ? ' | idle' : ' | simulating');
    if (sel.options.length !== s.renders) {
      sel.innerHTML = '';
      for (let i = 0; i < s.renders; i++) sel.add(new Option(i, i));
    }
    if (!s.is_idle) refresh();
    const cs = document.getElementById('crys');
    if (cs.options.length !== (s.crystals || []).length) {
      cs.innerHTML = '';
      for (const id of s.crystals) cs.add(new Option(id, id));
      loadCrystal();
    }
  } catch (e) {}
  setTimeout(poll, 1000);
}
document.getElementById('save').onclick = async () => {
  const text = await (await fetch('/project')).text();
  const a = document.createElement('a');
  a.href = URL.createObjectURL(new Blob([text], {type: 'application/json'}));
  a.download = 'project.json';
  a.click();
};
document.getElementById('loadbtn').onclick = () =>
  document.getElementById('load').click();
document.getElementById('load').onchange = async (e) => {
  const f = e.target.files[0];
  if (!f) return;
  const r = await fetch('/commit', {method: 'POST', body: await f.text()});
  const j = await r.json();
  document.getElementById('stat').textContent =
    r.ok ? (j.reused ? 'committed (reused)' : 'committed (restarted)')
         : ('commit error: ' + j.error);
  refresh();
};
// Wireframe crystal preview (reference: src/gui/crystal_renderer.cpp's
// FBO 3D view; here a canvas orthographic spin).
let mesh = null, ang = 0;
async function loadCrystal() {
  const cs = document.getElementById('crys');
  if (!cs.value) return;
  mesh = await (await fetch(`/crystal/${cs.value}.json`)).json();
}
document.getElementById('crys').onchange = loadCrystal;
setInterval(() => {
  if (!mesh) return;
  ang += 0.02;
  const c = document.getElementById('xtal').getContext('2d');
  c.clearRect(0, 0, 200, 200);
  c.strokeStyle = '#8fd3ff';
  const ca = Math.cos(ang), sa = Math.sin(ang), tilt = 0.5;
  let smax = 1e-6;
  for (const v of mesh.vertices) smax = Math.max(smax, Math.hypot(v[0], v[1], v[2]));
  const p2 = mesh.vertices.map(v => {
    const x = ca * v[0] + sa * v[1], y = -sa * v[0] + ca * v[1];
    const y2 = y * Math.cos(tilt) - v[2] * Math.sin(tilt);
    return [100 + 80 * x / smax, 100 + 80 * y2 / smax];
  });
  c.beginPath();
  for (const t of mesh.triangles) {
    for (let i = 0; i < 3; i++) {
      const a = p2[t[i]], b = p2[t[(i + 1) % 3]];
      c.moveTo(a[0], a[1]); c.lineTo(b[0], b[1]);
    }
  }
  c.stroke();
}, 50);
poll();
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    server_version = "iht-gui/1"

    def log_message(self, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        from ice_halo_sim_tpu_torch.utils.png import encode_png

        gui = self.server.gui  # type: ignore[attr-defined]
        url = urlparse(self.path)
        if url.path in ("/", "/index.html"):
            self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            return
        if url.path == "/status":
            frame = gui.frame()
            body = json.dumps({
                "ray_count": frame.ray_count if frame else 0,
                "state": gui.server.state().value,
                "generation": frame.generation if frame else -1,
                "is_idle": bool(frame.is_idle) if frame else False,
                "renders": len(frame.images) if frame else 0,
                "ev_auto": [round(float(e), 2) for e in (frame.ev_auto if frame else ())],
                "crystals": sorted(
                    (gui.server.config().crystals if gui.server.config() else {})
                ),
            }).encode()
            self._send(200, body, "application/json")
            return
        if url.path == "/project":
            from ice_halo_sim_tpu_torch.config.serialize import project_to_dict

            cfg = gui.server.config()
            if cfg is None:
                self._send(404, b"no project committed", "text/plain")
                return
            body = json.dumps(project_to_dict(cfg), indent=1).encode()
            self._send(200, body, "application/json")
            return
        if url.path.startswith("/crystal/") and url.path.endswith(".json"):
            from ice_halo_sim_tpu_torch.core import mesh as mesh_mod

            try:
                cid = int(url.path[len("/crystal/"):-len(".json")])
            except ValueError:
                self._send(404, b"bad crystal id", "text/plain")
                return
            cfg = gui.server.config()
            if cfg is None or cid not in cfg.crystals:
                self._send(404, b"unknown crystal", "text/plain")
                return
            m = mesh_mod.crystal_mesh(cfg.crystals[cid].shape)
            body = json.dumps({
                "id": cid,
                "vertices": np.asarray(m.vertices, np.float64).round(6).tolist(),
                "triangles": np.asarray(m.triangles).tolist(),
            }).encode()
            self._send(200, body, "application/json")
            return
        if url.path.startswith("/frame/") and url.path.endswith(".png"):
            try:
                r = int(url.path[len("/frame/"):-len(".png")])
            except ValueError:
                self._send(404, b"bad render index", "text/plain")
                return
            q = parse_qs(url.query)
            ev = float(q.get("ev", ["0"])[0])
            png = gui.render_png(r, ev)
            if png is None:
                self._send(404, b"no frame yet", "text/plain")
                return
            self._send(200, png, "image/png")
            return
        self._send(404, b"not found", "text/plain")

    def do_POST(self):  # noqa: N802
        gui = self.server.gui  # type: ignore[attr-defined]
        if urlparse(self.path).path != "/commit":
            self._send(404, b"not found", "text/plain")
            return
        n = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(n).decode()
        try:
            reused = gui.server.commit(body)
        except Exception as e:  # config errors -> 400, server stays alive
            self._send(400, json.dumps({"error": str(e)}).encode(),
                       "application/json")
            return
        gui.drop_frame()
        self._send(200, json.dumps({"reused": bool(reused)}).encode(),
                   "application/json")


class GuiApp:
    """Owns the Server and caches frames for the HTTP handlers.

    The cache stops refreshing once its frame is final (the budget is
    drained), and every successful commit through ``/commit`` drops it, so
    the next poll shows the committed scene, a layout change and an
    appearance-only recommit alike. This repairs a fault that the JAX
    package's gui/app.py still has: it keeps serving the finished scene's
    frame after a commit."""

    def __init__(self, server):
        self.server = server
        self._frame = None
        self._frame_t = 0.0
        self._lock = threading.Lock()

    def frame(self):
        with self._lock:
            # Snapshotting re-tone-maps the accumulators; 4 Hz is plenty
            # for a viewer and keeps the device free for simulation.
            if self._frame is None or (
                time.time() - self._frame_t > 0.25 and not self._frame_is_final()
            ):
                self._frame = self.server.acquire_frame()
                self._frame_t = time.time()
            return self._frame

    def drop_frame(self) -> None:
        """Forget the cached frame; the next poll acquires a new one."""
        with self._lock:
            self._frame = None

    def _frame_is_final(self) -> bool:
        return bool(self._frame is not None and self._frame.is_idle)

    def render_png(self, r: int, ev: float) -> Optional[bytes]:
        import torch

        from ice_halo_sim_tpu_torch.core import color
        from ice_halo_sim_tpu_torch.utils.png import encode_png

        frame = self.frame()
        if frame is None or r >= len(frame.images):
            return None
        if abs(ev) < 1e-6:
            return encode_png(np.asarray(frame.images[r]))
        rcfg = self.server.config().renders[r]
        # On the server's device, as JAX re-tone-maps on its device.
        img = color.post_process(
            torch.as_tensor(frame.raw_xyz[r]).to(self.server.device()),
            rcfg.intensity_factor * float(2.0 ** ev),
            float(frame.landed[r]),
            rcfg.background, rcfg.ray_color,
            use_real_color=rcfg.ray_color[0] < 0,
        )
        return encode_png(np.asarray(img))


def serve(config, host: str = "127.0.0.1", port: int = 8050,
          seed: int = 1, batch_size: Optional[int] = None,
          open_browser: bool = False, block: bool = True, device="cuda",
          kernels: Optional[str] = None):
    """Start the Server on `device`, commit `config` (path, JSON text,
    dict, or ProjectConfig), and serve the viewer. Returns (httpd, gui) when
    block=False (caller shuts down with httpd.shutdown();
    gui.server.shutdown())."""
    import os

    from ice_halo_sim_tpu_torch.engine.server import Server

    if isinstance(config, str) and len(config) < 4096 and "{" not in config \
            and os.path.exists(config):
        config = open(config).read()
    server = Server(seed=seed, batch_size=batch_size, device=device, kernels=kernels)
    try:
        server.commit(config)
    except BaseException:
        server.shutdown()
        raise
    gui = GuiApp(server)
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.gui = gui  # type: ignore[attr-defined]
    if open_browser:
        import webbrowser

        webbrowser.open(f"http://{host}:{httpd.server_address[1]}/")
    if not block:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd, gui
    try:
        print(f"viewing at http://{host}:{httpd.server_address[1]}/")
        httpd.serve_forever()
    finally:
        server.shutdown()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="live web viewer")
    p.add_argument("config")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8050)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--open", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    a = p.parse_args(argv)
    serve(a.config, a.host, a.port, seed=a.seed, open_browser=a.open, device=a.device)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
