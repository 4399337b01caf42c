#!/usr/bin/env python
"""Interactive viewer — the live front-end of the render pipeline.

The reference is an SDL3 window + ImGui TF editor driven by an event loop
(ref: common/pipeline.cu:267-301 init, :480-579 event polling, :608-731
present/UI).  This environment is headless, so the same loop is exposed
over HTTP instead of SDL: a browser page streams frames and posts mouse /
key / parameter events, which are routed to exactly the objects the
reference routes SDL events to — CameraManip (arcball/pan/dolly), the TFE
alpha editor (freehand LUT painting, range/opacity drags), and the uiParam
registry.  Everything renders through the same Pipeline the batch app uses
(apps/icon_rt.build), including runtime raygen/sampler/accel toggles.

Usage:
    python apps/viewer.py --synthetic 5:16 --size 512 512 --port 8890
    # then open http://localhost:8890/

Endpoints:
    GET  /            the UI page
    GET  /frame.png?since=N   long-poll: next frame after N (X-Frame-Id,
                      X-Fps, X-Edit-Latency-Ms, X-Accum-Id headers)
    GET  /tfe.png     the rasterized TF editor widget (LUT strip + alpha
                      curve + histogram, pipeline/tfe.rasterize)
    GET  /stats       JSON: fps, Mray/s, frame counter, edit latency
    POST /event       JSON events: {"type": "view"|"tfe", "etype":
                      "down"|"move"|"up", x, y, button, alt} |
                      {"type": "param", name, value} |
                      {"type": "key", key, shift}
"""
import json
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

_HTML = """<!DOCTYPE html>
<html><head><title>icon_dvr viewer</title><style>
body { background:#181818; color:#ddd; font:13px monospace; margin:16px }
canvas { border:1px solid #444; image-rendering: pixelated; }
#bar { margin:6px 0 } select,input { background:#222; color:#ddd }
</style></head><body>
<div id="bar">fps <span id="fps">-</span> | <span id="mray">-</span> Mray/s |
 accum <span id="accum">-</span> | TF-edit latency <span id="lat">-</span> ms |
 <span id="params"></span></div>
<canvas id="view" width="%W%" height="%H%"></canvas><br>
<canvas id="tfe" width="300" height="150"></canvas>
<div>drag globe: rotate &middot; alt+drag: pan &middot; right-drag: dolly
 &middot; paint the strip to edit the transfer function's alpha curve</div>
<script>
const view = document.getElementById('view'), vctx = view.getContext('2d');
const tfe = document.getElementById('tfe'), tctx = tfe.getContext('2d');
let since = -1;
async function frames() {
  for (;;) {
    try {
      const r = await fetch('/frame.png?since=' + since);
      if (r.status === 200) {
        since = parseInt(r.headers.get('X-Frame-Id'));
        document.getElementById('fps').textContent = r.headers.get('X-Fps');
        document.getElementById('mray').textContent = r.headers.get('X-Mray');
        document.getElementById('accum').textContent = r.headers.get('X-Accum-Id');
        document.getElementById('lat').textContent = r.headers.get('X-Edit-Latency-Ms');
        const blob = await r.blob();
        const img = await createImageBitmap(blob);
        vctx.drawImage(img, 0, 0);
      }
    } catch (e) { await new Promise(s => setTimeout(s, 500)); }
  }
}
async function tfeLoop() {
  for (;;) {
    try {
      const r = await fetch('/tfe.png?t=' + Date.now());
      const img = await createImageBitmap(await r.blob());
      tctx.drawImage(img, 0, 0);
    } catch (e) {}
    await new Promise(s => setTimeout(s, 250));
  }
}
function post(o) { fetch('/event', {method:'POST', body: JSON.stringify(o)}); }
function wire(el, type) {
  let down = false, last = 0;
  el.addEventListener('contextmenu', e => e.preventDefault());
  el.addEventListener('mousedown', e => { down = true;
    post({type, etype:'down', x:e.offsetX, y:e.offsetY, button:e.button,
          alt:e.altKey}); });
  window.addEventListener('mouseup', e => { if (!down) return; down = false;
    post({type, etype:'up', x:e.offsetX, y:e.offsetY, button:e.button,
          alt:e.altKey}); });
  el.addEventListener('mousemove', e => {
    if (!down || Date.now() - last < 30) return; last = Date.now();
    post({type, etype:'move', x:e.offsetX, y:e.offsetY, button:e.button,
          alt:e.altKey}); });
}
wire(view, 'view'); wire(tfe, 'tfe');
window.addEventListener('keydown', e =>
  post({type:'key', key:e.key, shift:e.shiftKey}));
fetch('/params').then(r => r.json()).then(ps => {
  const bar = document.getElementById('params');
  for (const p of ps) {
    if (!p.options) {
      if (typeof p.value !== 'number' || p.minf == null) continue;
      const l = document.createElement('label');
      l.textContent = ' ' + p.name + ' ';
      const r = document.createElement('input');
      r.type = 'range'; r.min = p.minf; r.max = p.maxf;
      r.step = (p.maxf - p.minf) / 200; r.value = p.value;
      r.oninput = () => post({type:'param', name:p.name, value:+r.value});
      l.appendChild(r); bar.appendChild(l);
      continue;
    }
    const s = document.createElement('select');
    for (const [i, o] of p.options.entries()) {
      const op = document.createElement('option');
      op.value = i; op.textContent = p.name + ': ' + o;
      if (o === String(p.value) || i === p.value) op.selected = true;
      s.appendChild(op);
    }
    s.onchange = () => post({type:'param', name:p.name,
                             value: p.string ? p.options[s.value] : +s.value});
    bar.appendChild(s);
  }
});
frames(); tfeLoop();
</script></body></html>"""


class ViewerState:
    """Shared state between the render loop (owner) and HTTP threads."""

    def __init__(self):
        self.events = queue.Queue()
        self.cond = threading.Condition()
        self.frame_id = -1            # monotonically increasing presented id
        self.png = b""
        self.fps = 0.0
        self.mray = 0.0
        self.accum_id = 0
        self.edit_latency_ms = -1.0
        self.stop = False
        self.params_json = b"[]"
        self.tfe_png = b""


def _make_handler(st: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _bytes(self, data, ctype, headers=()):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path, _, qs = self.path.partition("?")
            if path == "/":
                self._bytes(st.html, "text/html")
            elif path == "/frame.png":
                since = -1
                for kv in qs.split("&"):
                    if kv.startswith("since="):
                        since = int(kv[6:])
                with st.cond:
                    st.cond.wait_for(lambda: st.frame_id > since or st.stop,
                                     timeout=15.0)
                    if st.frame_id <= since:
                        self.send_response(204)
                        self.end_headers()
                        return
                    png, fid = st.png, st.frame_id
                    heads = [("X-Frame-Id", str(fid)),
                             ("X-Fps", f"{st.fps:.1f}"),
                             ("X-Mray", f"{st.mray:.1f}"),
                             ("X-Accum-Id", str(st.accum_id)),
                             ("X-Edit-Latency-Ms",
                              f"{st.edit_latency_ms:.0f}")]
                self._bytes(png, "image/png", heads)
            elif path == "/tfe.png":
                self._bytes(st.tfe_png, "image/png")
            elif path == "/stats":
                with st.cond:
                    data = json.dumps({
                        "frame_id": st.frame_id, "fps": st.fps,
                        "mray": st.mray, "accum_id": st.accum_id,
                        "edit_latency_ms": st.edit_latency_ms,
                    }).encode()
                self._bytes(data, "application/json")
            elif path == "/params":
                self._bytes(st.params_json, "application/json")
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path.partition("?")[0] != "/event":
                self.send_response(404)
                self.end_headers()
                return
            n = int(self.headers.get("Content-Length", "0"))
            try:
                ev = json.loads(self.rfile.read(n))
            except Exception:
                self.send_response(400)
                self.end_headers()
                return
            ev["_t"] = time.perf_counter()
            st.events.put(ev)
            self._bytes(b"{}", "application/json")

    return Handler


def serve(pl, port: int = 8890, host: str = "127.0.0.1",
          max_frames: int | None = None, state: ViewerState | None = None):
    """Run the interactive loop on `pl` (a fully-wired apps/icon_rt
    Pipeline), serving the UI on http://host:port/.

    max_frames bounds the loop for scripted/recorded sessions (None =
    until SIGINT).  Returns the ViewerState (for tests/drivers)."""
    from icon_dvr.ops.camera import CameraManip
    from icon_dvr.ops.render import fb_to_image
    from icon_dvr.pipeline.tfe import MouseEvent
    from icon_dvr.utils.png import encode_png

    st = state or ViewerState()
    st.html = (_HTML.replace("%W%", str(pl.width))
               .replace("%H%", str(pl.height)).encode())
    pl.interactive = True
    if pl.sample_limit <= 1:
        pl.sample_limit = 64     # progressive convergence cap per view
    if pl.preview_scale == 0:
        # sub-second perceived edits/moves: first
        # frame after any reset renders at 1/4 res and presents upscaled
        pl.preview_scale = 4

    manip = CameraManip(pl.camera, pl.width, pl.height)
    params = []
    for p in pl.ui_params:
        opts = p.meta.get("options")
        val = p.get()
        if isinstance(val, (np.floating, np.integer)):
            val = val.item()
        params.append({"name": p.name, "options": opts, "value": val,
                       "string": isinstance(val, str),
                       "minf": (None if p.meta.get("minf") is None
                                else float(p.meta["minf"])),
                       "maxf": (None if p.meta.get("maxf") is None
                                else float(p.meta["maxf"]))})
    st.params_json = json.dumps(params).encode()

    def rasterize_tfe():
        if pl.tfe is not None:
            st.tfe_png = encode_png(pl.tfe.rasterize(), flip_vertically=False,
                                    level=1)

    rasterize_tfe()

    httpd = ThreadingHTTPServer((host, port), _make_handler(st))
    st.port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print(f"viewer: http://{host}:{st.port}/", flush=True)

    buttons = {0: CameraManip.LEFT, 1: CameraManip.MIDDLE, 2: CameraManip.RIGHT}
    pending_edit_t = None
    frames_done = 0

    def apply_event(ev):
        nonlocal pending_edit_t
        t = ev.get("type")
        if t == "view":
            btn = buttons.get(int(ev.get("button", 0)), CameraManip.LEFT)
            mod = CameraManip.ALT if ev.get("alt") else CameraManip.NOMOD
            x, y = int(ev["x"]), int(ev["y"])
            if ev["etype"] == "down":
                manip.handle_mouse_down(x, y, btn, mod)
            elif ev["etype"] == "up":
                manip.handle_mouse_up(x, y, btn, mod)
            elif manip.handle_mouse_move(x, y, mod):
                pl.reset_accumulation()
                pending_edit_t = pending_edit_t or ev["_t"]
        elif t == "tfe" and pl.tfe is not None:
            et = {"down": MouseEvent.PRESS, "move": MouseEvent.MOTION,
                  "up": MouseEvent.RELEASE}[ev["etype"]]
            pl.tfe.handle_mouse_event(
                MouseEvent(int(ev["x"]), int(ev["y"]),
                           button=MouseEvent.LEFT, etype=et))
            pending_edit_t = pending_edit_t or ev["_t"]
            rasterize_tfe()
        elif t == "param":
            pl.set_ui_param(ev["name"], ev["value"])
            pending_edit_t = pending_edit_t or ev["_t"]
        elif t == "key":
            pl.handle_key(ev["key"], bool(ev.get("shift")))

    try:
        while not st.stop:
            had_event = False
            try:
                while True:
                    apply_event(st.events.get_nowait())
                    had_event = True
            except queue.Empty:
                pass
            # TFE dirty harvest + accumulation advance/reset
            # (ref: pipeline.cu:991-1034)
            if pl._started:
                pl.is_running()
            if pl.frame_id >= pl.sample_limit and not had_event:
                time.sleep(0.02)   # converged and idle
                continue
            if pl.frame_id < pl.sample_limit:
                pl.launch()
                fb = np.asarray(pl._last_fb)
                # unpermute through the app's present path
                buf = {}
                orig_write = pl.write_frame
                pl.write_frame = lambda f: buf.__setitem__("fb", f)
                try:
                    pl.present()
                finally:
                    pl.write_frame = orig_write
                img = fb_to_image(buf.get("fb", fb), pl.width, pl.height,
                                  bgcolor=pl.bgcolor)
                png = encode_png(img, level=1)
                now = time.perf_counter()
                with st.cond:
                    st.png = png
                    st.frame_id += 1
                    st.fps = 1.0 / max(pl.avg_t, 1e-9)
                    st.mray = pl.width * pl.height / max(pl.avg_t, 1e-9) / 1e6
                    st.accum_id = pl.frame_id
                    if pending_edit_t is not None:
                        st.edit_latency_ms = (now - pending_edit_t) * 1e3
                        pending_edit_t = None
                    st.cond.notify_all()
                frames_done += 1
                if max_frames is not None and frames_done >= max_frames:
                    break
    finally:
        st.stop = True
        with st.cond:
            st.cond.notify_all()
        httpd.shutdown()
    return st


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    port = 8890
    host = "127.0.0.1"
    if "--port" in argv:
        i = argv.index("--port")
        port = int(argv[i + 1])
        del argv[i:i + 2]
    if "--host" in argv:
        i = argv.index("--host")
        host = argv[i + 1]
        del argv[i:i + 2]
    import icon_rt
    pl = icon_rt.build(argv)
    if pl is None:
        return 1
    serve(pl, port=port, host=host)
    return 0


if __name__ == "__main__":
    sys.exit(main())
