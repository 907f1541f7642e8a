"""Web project GUI (PyTorch port of ``pipeline/gui.py``): ``mdvt-torch
gui``.

A single page over the stdlib HTTP server, on the project format of
``pipeline/project.py``: the scene table with per-scene Engine / Infill /
Convergence overrides, scene splitting, a player of each scene's clip,
SBS and infilled files (JPEG frames and an MJPEG stream), the project's
config, and the pipeline's run with its live log.

The run works in ONE worker thread (the card is one resource) while the
HTTP handlers answer on the server's threads; its stdout and stderr go
into a ring of log lines that the page polls. The movie pipeline resumes
by the files it finds, so a run started again continues where one
stopped.

Run: ``mdvt-torch gui --project_dir <dir> [--port 8123]``, then open the
URL; it serves until interrupted.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from metric_depth_video_toolbox_tpu_torch.pipeline import project as proj_mod
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


class _LogBuffer(io.TextIOBase):
    """Thread-safe ring of the run's log lines (the page polls it)."""

    def __init__(self, max_lines=2000):
        self.lines = []
        self.max_lines = max_lines
        self._lock = threading.Lock()
        self._partial = ""

    def write(self, s):
        with self._lock:
            self._partial += s
            while "\n" in self._partial:
                line, self._partial = self._partial.split("\n", 1)
                self.lines.append(line)
            del self.lines[:-self.max_lines]
        return len(s)

    def flush(self):
        pass

    def tail(self, start=0):
        """-> (the lines from ``start`` on, the count of lines kept)"""
        with self._lock:
            return self.lines[start:], len(self.lines)


class _Player:
    """The scene player's video access: one OpenCV capture per open file
    behind one lock (the handlers run concurrently). OpenCV is imported
    when a file is first opened."""

    def __init__(self):
        self._caps = {}
        self._lock = threading.Lock()
        self._pos = {}

    def _cap(self, path):
        import cv2
        cap = self._caps.get(path)
        if cap is None:
            cap = cv2.VideoCapture(path)
            if not cap.isOpened():
                raise FileNotFoundError(path)
            self._caps[path] = cap
            self._pos[path] = 0
        return cap

    def meta(self, path):
        import cv2
        with self._lock:
            cap = self._cap(path)
            return {"frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                    "fps": float(cap.get(cv2.CAP_PROP_FPS)) or 24.0,
                    "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                    "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))}

    def jpeg_frame(self, path, index, max_w=1280, quality=85):
        """JPEG bytes of frame ``index``, at most ``max_w`` wide."""
        import cv2
        with self._lock:
            cap = self._cap(path)
            # sequential reads (play) skip the seek; the intra-only codecs
            # written here seek exactly
            if index != self._pos[path]:
                cap.set(cv2.CAP_PROP_POS_FRAMES, index)
            ok, bgr = cap.read()
            if not ok:  # past the end: rewind and read once more
                cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
                ok, bgr = cap.read()
                self._pos[path] = 0
                if not ok:
                    raise ValueError(f"no frame {index} in {path}")
            self._pos[path] = index + 1
            if bgr.shape[1] > max_w:
                s = max_w / bgr.shape[1]
                bgr = cv2.resize(bgr, (max_w, max(1, round(
                    bgr.shape[0] * s))), interpolation=cv2.INTER_AREA)
            ok, buf = cv2.imencode(".jpg", bgr,
                                   [cv2.IMWRITE_JPEG_QUALITY, quality])
            return buf.tobytes()

    def close(self):
        with self._lock:
            for cap in self._caps.values():
                cap.release()
            self._caps.clear()


class GuiState:
    """The GUI's state: the project directory, the run's worker thread
    and log, and the player. The run works on ``device`` (CUDA unless the
    caller asks for the CPU)."""

    def __init__(self, project_dir, device=None):
        self.project_dir = os.path.abspath(project_dir)
        self.device = resolve_device(device)
        self.log = _LogBuffer()
        self.worker = None
        self.running = False
        self.last_error = None
        self.player = _Player()

    def safe_path(self, rel):
        """A client's relative path resolved inside the project directory;
        PermissionError for one that leaves it."""
        p = os.path.realpath(os.path.join(self.project_dir, rel))
        root = os.path.realpath(self.project_dir)
        if not (p == root or p.startswith(root + os.sep)):
            raise PermissionError(rel)
        return p

    def scene_files(self, scene_no):
        """The scene's files that exist, as paths relative to the project
        directory, by kind (clip, depth, mask, sbs, infilled)."""
        from metric_depth_video_toolbox_tpu_torch.pipeline import movie
        proj = self.project()
        for s in movie.plan_scene_files(proj.scenes(), proj.root):
            if int(s["Scene Number"]) != int(scene_no):
                continue
            out = {}
            for kind, key in (("clip", "scene_video_file"),
                              ("depth", "depth_video_file"),
                              ("mask", "mask_video_file"),
                              ("sbs", "sbs"), ("infilled", "infilled")):
                if os.path.exists(s[key]):
                    out[kind] = os.path.relpath(s[key], self.project_dir)
            return out
        raise KeyError(f"scene {scene_no}")

    def project(self):
        return proj_mod.open_project(self.project_dir)

    def start_run(self, end_scene=-1):
        """Start the movie pipeline on the worker thread; False if a run
        is under way."""
        if self.running:
            return False
        self.running = True
        self.last_error = None

        def work():
            try:
                with contextlib.redirect_stdout(self.log), \
                        contextlib.redirect_stderr(self.log):
                    proj_mod.run_project(self.project(), end_scene=end_scene,
                                         device=self.device)
                self.log.write("\n[run finished]\n")
            except Exception as e:  # shown on the page, not lost
                self.last_error = str(e)
                self.log.write(f"\n[run failed] {e}\n")
            finally:
                self.running = False

        self.worker = threading.Thread(target=work, daemon=True)
        self.worker.start()
        return True


PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>MDVT project</title>
<style>
 body{font-family:system-ui,sans-serif;margin:1.2em;background:#16181d;color:#dde}
 h1{font-size:1.2em} table{border-collapse:collapse;margin:1em 0}
 td,th{border:1px solid #444;padding:.3em .6em;font-size:.9em}
 .ok{color:#7c6} .no{color:#c67} button{margin-right:.5em}
 #log{background:#0b0c0f;color:#9b9;white-space:pre;font-family:monospace;
      font-size:.8em;height:18em;overflow-y:scroll;padding:.5em;border:1px solid #333}
 input,select{background:#22252c;color:#dde;border:1px solid #555}
 #player{display:none;position:fixed;top:4%;left:50%;transform:translateX(-50%);
   background:#0b0c0f;border:1px solid #666;padding:.8em;z-index:9;max-width:92vw}
 #pimg{max-width:88vw;max-height:70vh;display:block;background:#000}
 #pbar{width:100%}
</style></head><body>
<h1>MDVT project <span id="root"></span></h1>
<div>
 <button onclick="runPipe()">Run pipeline</button>
 <span id="state"></span>
</div>
<table id="scenes"></table>
<div id="player">
 <div><b id="ptitle"></b>
  <button onclick="togglePlay()" id="pbtn">play</button>
  <span id="pframe"></span>
  <button style="float:right" onclick="closePlayer()">close</button></div>
 <img id="pimg">
 <input type="range" id="pbar" min="0" max="0" value="0"
        oninput="scrub(this.value)">
</div>
<h3>Config</h3><table id="config"></table>
<h3>Log</h3><div id="log"></div>
<script>
let logLen = 0;
let pv = {file:null, frames:0, fps:24, i:0, playing:false};
async function openPlayer(scene, kind){
  const sf = await j('/api/scene_files?scene='+scene);
  if(sf.error || !sf.files[kind]){ alert('not produced yet'); return; }
  pv.file = sf.files[kind]; pv.frames = sf.meta[kind].frames;
  pv.fps = sf.meta[kind].fps; pv.i = 0; pv.playing = false;
  document.getElementById('ptitle').textContent = 'scene '+scene+' — '+kind;
  document.getElementById('pbar').max = Math.max(0, pv.frames-1);
  document.getElementById('player').style.display = 'block';
  scrub(0);
}
function showFrame(){
  document.getElementById('pimg').src =
    '/video/frame?f='+encodeURIComponent(pv.file)+'&i='+pv.i+'&t='+Date.now();
  document.getElementById('pbar').value = pv.i;
  document.getElementById('pframe').textContent = pv.i+' / '+pv.frames;
}
function scrub(v){
  pv.playing = false; document.getElementById('pbtn').textContent='play';
  pv.i = parseInt(v); showFrame();
}
function togglePlay(){
  pv.playing = !pv.playing;
  document.getElementById('pbtn').textContent = pv.playing ? 'pause' : 'play';
  if(pv.playing){  // MJPEG push stream from the current position
    document.getElementById('pimg').src =
      '/video/stream?f='+encodeURIComponent(pv.file)+'&start='+pv.i;
    pv.t0 = Date.now(); pv.i0 = pv.i;
    pv.timer = setInterval(()=>{   // advance the scrubber with time
      pv.i = Math.min(pv.frames-1,
        pv.i0 + Math.round((Date.now()-pv.t0)/1000*pv.fps));
      document.getElementById('pbar').value = pv.i;
      document.getElementById('pframe').textContent = pv.i+' / '+pv.frames;
      if(pv.i >= pv.frames-1) scrub(pv.i);
    }, 250);
  } else { clearInterval(pv.timer); showFrame(); }
}
function closePlayer(){
  pv.playing = false; clearInterval(pv.timer);
  document.getElementById('pimg').src = '';
  document.getElementById('player').style.display = 'none';
}
async function j(url, opts){const r = await fetch(url, opts); return r.json();}
async function refresh(){
  const st = await j('/api/status');
  document.getElementById('root').textContent = st.root;
  document.getElementById('state').textContent =
      st.running ? 'RUNNING' : (st.last_error ? 'ERROR: '+st.last_error : 'idle');
  const t = document.getElementById('scenes');
  let h = '<tr><th>scene</th><th>frames</th><th>engine</th><th>clip</th>'+
          '<th>depth</th><th>mask</th><th>sbs</th><th>infilled</th>'+
          '<th>override</th><th>split</th></tr>';
  for(const s of st.scenes){
    const c = x => x ? '<td class=ok>✓</td>' : '<td class=no>–</td>';
    const p = k => `<button onclick="openPlayer(${s.scene},'${k}')">${k}</button>`;
    h += `<tr><td>${s.scene}</td><td>${s.frames}</td><td>${s.engine}</td>`+
         c(s.clip)+c(s.depth)+c(s.mask)+c(s.sbs)+c(s.infilled)+
         `<td>`+p('clip')+p('sbs')+p('infilled')+`</td>`+
         `<td><select id="col${s.scene}"><option>Engine</option>`+
         `<option>Infill</option><option>Convergence</option></select>`+
         `<input id="val${s.scene}" size=8>`+
         `<button onclick="setOv(${s.scene})">set</button></td>`+
         `<td><input id="sp${s.scene}" size=6 placeholder="frame">`+
         `<button onclick="splitSc(${s.scene})">split</button></td></tr>`;
  }
  t.innerHTML = h;
  const cfgT = document.getElementById('config');
  cfgT.innerHTML = Object.entries(st.config).map(
    ([k,v]) => `<tr><th>${k}</th><td>${v}</td></tr>`).join('');
}
async function poll(){
  const l = await j('/api/logs?start='+logLen);
  if(l.lines.length){
    const d = document.getElementById('log');
    d.textContent += l.lines.join('\\n')+'\\n';
    d.scrollTop = d.scrollHeight;
  }
  logLen = l.total;
}
async function runPipe(){ await j('/api/run', {method:'POST'}); refresh(); }
async function setOv(n){
  const col = document.getElementById('col'+n).value;
  const val = document.getElementById('val'+n).value;
  await j('/api/set', {method:'POST', body: JSON.stringify({scene:n, column:col, value:val})});
  refresh();
}
async function splitSc(n){
  const at = parseInt(document.getElementById('sp'+n).value);
  await j('/api/split', {method:'POST', body: JSON.stringify({scene:n, at_frame:at})});
  refresh();
}
refresh(); setInterval(refresh, 5000); setInterval(poll, 1500);
</script></body></html>
"""


def make_handler(state: GuiState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet server
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                body = PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/api/status":
                try:
                    proj = state.project()
                    self._json({
                        "root": state.project_dir,
                        "running": state.running,
                        "last_error": state.last_error,
                        "config": proj.config,
                        "scenes": proj_mod.status(proj),
                    })
                except Exception as e:
                    self._json({"error": str(e)}, 500)
            elif url.path == "/api/logs":
                q = urllib.parse.parse_qs(url.query)
                start = int(q.get("start", ["0"])[0])
                lines, total = state.log.tail(start)
                self._json({"lines": lines, "total": total})
            elif url.path == "/api/scene_files":
                q = urllib.parse.parse_qs(url.query)
                try:
                    files = state.scene_files(q["scene"][0])
                    meta = {k: state.player.meta(state.safe_path(v))
                            for k, v in files.items()}
                    self._json({"files": files, "meta": meta})
                except Exception as e:
                    self._json({"error": str(e)}, 404)
            elif url.path == "/video/frame":
                q = urllib.parse.parse_qs(url.query)
                try:
                    path = state.safe_path(q["f"][0])
                    idx = int(q.get("i", ["0"])[0])
                    jpg = state.player.jpeg_frame(path, idx)
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpg)))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(jpg)
                except Exception as e:
                    self._json({"error": str(e)}, 404)
            elif url.path == "/video/stream":
                # MJPEG push stream (multipart/x-mixed-replace): the
                # browser <img> plays it natively; server paces at the
                # source fps. One handler thread per viewer.
                q = urllib.parse.parse_qs(url.query)
                try:
                    path = state.safe_path(q["f"][0])
                    start = int(q.get("start", ["0"])[0])
                    meta = state.player.meta(path)
                except Exception as e:
                    self._json({"error": str(e)}, 404)
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=mdvtframe")
                self.end_headers()
                import time as _time
                period = 1.0 / max(1.0, min(60.0, meta["fps"]))
                i = start
                try:
                    while i < meta["frames"]:
                        t0 = _time.monotonic()
                        jpg = state.player.jpeg_frame(path, i)
                        self.wfile.write(
                            b"--mdvtframe\r\n"
                            b"Content-Type: image/jpeg\r\n"
                            b"Content-Length: %d\r\n"
                            b"X-Frame-Index: %d\r\n\r\n"
                            % (len(jpg), i))
                        self.wfile.write(jpg)
                        self.wfile.write(b"\r\n")
                        self.wfile.flush()
                        i += 1
                        dt = _time.monotonic() - t0
                        if dt < period:
                            _time.sleep(period - dt)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the page closed the player
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            data = json.loads(self.rfile.read(n) or b"{}")
            try:
                if self.path == "/api/run":
                    started = state.start_run(
                        end_scene=data.get("end_scene", -1))
                    self._json({"started": started})
                elif self.path == "/api/set":
                    proj_mod.set_scene_override(
                        state.project(), data["scene"], data["column"],
                        data["value"])
                    self._json({"ok": True})
                elif self.path == "/api/split":
                    proj_mod.split_scene(state.project(), data["scene"],
                                         data["at_frame"])
                    self._json({"ok": True})
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:
                self._json({"error": str(e)}, 400)

    return Handler


def serve(project_dir, port=8123, open_browser=False, device=None):
    """Serve the GUI until interrupted; ``open_browser`` is accepted and
    not used, as in the JAX package. -> the server"""
    del open_browser
    state = GuiState(project_dir, device=device)
    srv = ThreadingHTTPServer(("127.0.0.1", port), make_handler(state))
    print(f"MDVT project GUI: http://127.0.0.1:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        state.player.close()
    return srv


def serve_background(project_dir, port=0, device=None):
    """The GUI on a free port (``port`` 0) in a daemon thread. ->
    (server, state, port); stop it with ``server.shutdown()`` and
    ``server.server_close()``."""
    state = GuiState(project_dir, device=device)
    srv = ThreadingHTTPServer(("127.0.0.1", port), make_handler(state))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, state, srv.server_address[1]
