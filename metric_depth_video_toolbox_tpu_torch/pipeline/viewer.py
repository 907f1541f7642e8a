"""Interactive 3D depth-video viewer (PyTorch port of
``pipeline/viewer.py``): ``view`` without ``--render``.

A stdlib HTTP server decodes frames on demand and sends compact binary
point grids to an embedded WebGL page with orbit / pan / zoom, play /
pause at the video's frame rate, a frame scrubber, mesh or point display,
the camera's frustum and an optional background PLY.

Wire format of a frame (little-endian):
    u32 magic 0x4D445654 ('MDVT'), u16 gh, u16 gw,
    f32 bbox_min[3], f32 bbox_scale[3],
    then gh*gw * (u16 x, u16 y, u16 z)   positions, quantized to the bbox
    then gh*gw * (u8 r, u8 g, u8 b)      colors
    then 8 * f32[3]                       the camera frustum's corners
Invalid vertices (culled edges, masked, zero depth) carry 0xFFFF; the
page's vertex shader drops any triangle touching one.

The grid is the depth map subsampled by the smallest integer stride that
gives gh*gw <= max_points, so the page keeps one index buffer and only
the vertex buffers change per frame. Per frame the device decodes the
depth (R as the code's high byte, the codec's default), unprojects, culls
edges, transforms and slices the grid; the host quantizes.
"""

from __future__ import annotations

import json
import struct
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.io import pointcloud as pcio
from metric_depth_video_toolbox_tpu_torch.ops import codec
from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
from metric_depth_video_toolbox_tpu_torch.ops import rasterize
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device

MAGIC = 0x4D445654
CACHE_FRAMES = 32
INVALID = 0xFFFF          # the position code of an invalid vertex


def unpack_frame(blob):
    """A frame's wire-format bytes -> ((magic, gh, gw), bbox min and scale
    (6,) float32, positions (gh, gw, 3) u16, colors (gh, gw, 3) u8,
    frustum corners (24,) float32)."""
    magic, gh, gw = struct.unpack_from("<IHH", blob, 0)
    box = np.frombuffer(blob, "<f4", 6, 8)
    off = 32
    q = np.frombuffer(blob, "<u2", gh * gw * 3, off).reshape(gh, gw, 3)
    off += gh * gw * 6
    cols = np.frombuffer(blob, np.uint8, gh * gw * 3, off).reshape(gh, gw, 3)
    off += gh * gw * 3
    if off + 96 != len(blob):
        raise ValueError(f"a frame of {len(blob)} bytes for a {gh} x {gw} "
                         f"grid")
    return (magic, gh, gw), box, q, cols, np.frombuffer(blob, "<f4", 24, off)


class FrameSource:
    """Random-access decoder: frame index -> the frame's wire-format blob,
    computed on ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, depth_video, color_video=None, mask_video=None,
                 invert_mask=False, xfov=50.0, yfov=None, max_depth=100.0,
                 transformations=None, transformation_lock_frame=0,
                 remove_edges=True, max_points=400_000, max_frames=-1,
                 device=None):
        from metric_depth_video_toolbox_tpu_torch.io import video as vio

        self.device = resolve_device(device)
        self.dv = vio.VideoReader(depth_video, max_frames=max_frames)
        self.cv = vio.VideoReader(color_video) if color_video else None
        self.mv = vio.VideoReader(mask_video) if mask_video else None
        self.invert_mask = invert_mask
        self.max_depth = max_depth
        self.remove_edges = remove_edges
        h, w = self.dv.height, self.dv.width
        self.h, self.w = h, w
        self.fps = self.dv.fps or 24.0
        self.frame_count = self.dv.frame_count
        if max_frames > 0:
            self.frame_count = min(self.frame_count, max_frames)
        self.k = geo.camera_matrix_from_fov(w, h, xfov_deg=xfov,
                                            yfov_deg=yfov)
        self._k_dev = self.k.to(self.device)
        stride = 1
        while (h // stride) * (w // stride) > max_points:
            stride += 1
        self.stride = stride
        self.gh, self.gw = h // stride, w // stride
        self.transforms = None
        if transformations is not None:
            tf = np.asarray(transformations, np.float32)
            if transformation_lock_frame != 0:
                tf = tf @ np.linalg.inv(tf[transformation_lock_frame])
            self.transforms = tf
        self._lock = threading.Lock()
        self._cache = {}

    def _device_step(self, depth_rgb, color, transform):
        """Decode, unproject, cull edges and transform on the device; ->
        the strided grid's world points, validity and colors on the
        host."""
        depth = codec.decode_depth_frame(depth_rgb, self.max_depth)
        pts = geo.unproject_depth(depth, self._k_dev)
        valid = depth > 1e-4
        if self.remove_edges:
            valid = valid & ~rasterize.cell_edge_mask(pts)
        world = geo.transform_depth_map(pts, transform)
        s = self.stride
        rows, cols = slice(0, self.gh * s, s), slice(0, self.gw * s, s)
        return (world[rows, cols].cpu().numpy(),
                valid[rows, cols].cpu().numpy(),
                color[rows, cols].cpu().numpy())

    def frame_payload(self, n):
        """Frame ``n``'s blob, None past the end. Thread-safe; the last
        ``CACHE_FRAMES`` frames are kept, so scrubbing does not decode
        again."""
        with self._lock:
            if n in self._cache:
                return self._cache[n]
            depth_rgb = self.dv.read_frame(n)
            if depth_rgb is None:
                return None
            color = (self.cv.read_frame(n) if self.cv is not None
                     else depth_rgb)
            if color is None:
                color = depth_rgb
            tf = (self.transforms[n] if self.transforms is not None
                  and n < len(self.transforms)
                  else np.eye(4, dtype=np.float32))
            dev = self.device
            world, valid, cols = self._device_step(
                torch.from_numpy(depth_rgb).to(dev),
                torch.from_numpy(color).to(dev),
                torch.as_tensor(np.asarray(tf, np.float32), device=dev))
            if self.mv is not None:
                mk = self.mv.read_frame(n)
                if mk is not None:
                    fg = mk[::self.stride, ::self.stride][
                        :self.gh, :self.gw].mean(-1) > 128
                    valid = valid & (fg if self.invert_mask else ~fg)
            blob = self._pack(world, valid, cols, tf)
            self._cache[n] = blob
            if len(self._cache) > CACHE_FRAMES:
                self._cache.pop(next(iter(self._cache)))
            return blob

    def _pack(self, world, valid, cols, transform):
        w = np.asarray(world, np.float32)
        v = np.asarray(valid)
        vw = w[v] if v.any() else np.zeros((1, 3), np.float32)
        lo = vw.min(0)
        span = np.maximum(vw.max(0) - lo, 1e-6)
        q = np.clip((w - lo) / span, 0.0, 1.0)
        q16 = np.minimum((q * 65534.0).astype(np.uint16), 65534)
        q16[~v] = INVALID
        far = float(np.percentile(vw[:, 2], 95)) if v.any() else 10.0
        corners = geo.frustum_corners(
            self.k, self.w, self.h, near=max(far, 0.5) * 0.02,
            far=max(far, 0.5),
            cam_to_world=torch.as_tensor(np.asarray(transform, np.float32)))
        head = struct.pack("<IHH", MAGIC, self.gh, self.gw)
        head += struct.pack("<6f", *lo.tolist(), *span.tolist())
        return (head + q16.astype("<u2").tobytes()
                + np.asarray(cols, np.uint8).tobytes()
                + corners.numpy().astype("<f4").tobytes())

    def close(self):
        self.dv.close()
        if self.cv is not None:
            self.cv.close()
        if self.mv is not None:
            self.mv.close()


PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>MDVT 3D viewer</title>
<style>
 body{margin:0;background:#101216;color:#dde;font-family:system-ui,sans-serif;
      overflow:hidden}
 #hud{position:fixed;left:.8em;top:.6em;background:#0009;padding:.5em .8em;
      border-radius:.4em;font-size:.85em;z-index:2}
 #bar{position:fixed;left:0;right:0;bottom:0;background:#0009;padding:.5em;
      display:flex;gap:.6em;align-items:center;z-index:2}
 #seek{flex:1}
 canvas{display:block;width:100vw;height:100vh}
 button{background:#22252c;color:#dde;border:1px solid #555;border-radius:.3em}
</style></head><body>
<div id="hud">drag orbit &middot; shift-drag pan &middot; wheel zoom<br>
 <span id="info"></span></div>
<canvas id="gl"></canvas>
<div id="bar">
 <button id="play">&#9654;</button>
 <input id="seek" type="range" min="0" value="0" step="1">
 <span id="fno"></span>
 <label><input id="mesh" type="checkbox" checked> mesh</label>
 <label><input id="frus" type="checkbox"> camera</label>
</div>
<script>
"use strict";
const cv = document.getElementById('gl');
const gl = cv.getContext('webgl');
gl.getExtension('OES_element_index_uint'); // 32-bit mesh indices
let meta=null, playing=false, frame=0, bg=null, last=0;
const VS=`attribute vec3 aq; attribute vec3 ac; uniform mat4 mvp;
uniform vec3 lo; uniform vec3 span; uniform float psz;
uniform float noSent; // 1 = raw-float geometry (frustum): no u16 sentinel
varying vec3 vc; varying float vv;
void main(){
  vv = (noSent < 0.5 && aq.z >= 65535.0) ? 0.0 : 1.0;
  vec3 p = lo + span * (aq / 65534.0);
  gl_Position = mvp * vec4(p, 1.0);
  gl_PointSize = psz / max(gl_Position.w, 0.1);
  vc = ac / 255.0;
}`;
const FS=`precision mediump float; varying vec3 vc; varying float vv;
void main(){ if (vv < 0.999) discard; gl_FragColor = vec4(vc,1.0); }`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
 gl.compileShader(o);if(!gl.getShaderParameter(o,gl.COMPILE_STATUS))
 throw gl.getShaderInfoLog(o);return o;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog); gl.useProgram(prog);
const loc={aq:gl.getAttribLocation(prog,'aq'),ac:gl.getAttribLocation(prog,'ac'),
 mvp:gl.getUniformLocation(prog,'mvp'),lo:gl.getUniformLocation(prog,'lo'),
 span:gl.getUniformLocation(prog,'span'),psz:gl.getUniformLocation(prog,'psz'),
 noSent:gl.getUniformLocation(prog,'noSent')};
const qbuf=gl.createBuffer(), cbuf=gl.createBuffer(), ibuf=gl.createBuffer();
let nidx=0, gh=0, gw=0, cur={lo:[0,0,0],span:[1,1,1]}, frus=null;
const fbuf=gl.createBuffer(), fcol=gl.createBuffer();
// camera state: orbit around target
let cam={d:4, th:0, ph:-0.2, tgt:[0,0,2]};
function mat(){
  const a=cv.width/cv.height, f=1/Math.tan(0.4), n=0.01, fr=2000;
  const P=[f/a,0,0,0, 0,f,0,0, 0,0,(fr+n)/(n-fr),-1, 0,0,2*fr*n/(n-fr),0];
  const cp=[cam.tgt[0]+cam.d*Math.sin(cam.th)*Math.cos(cam.ph),
            cam.tgt[1]+cam.d*Math.sin(cam.ph),
            cam.tgt[2]-cam.d*Math.cos(cam.th)*Math.cos(cam.ph)];
  let zx=cam.tgt[0]-cp[0],zy=cam.tgt[1]-cp[1],zz=cam.tgt[2]-cp[2];
  const zl=Math.hypot(zx,zy,zz); zx/=zl;zy/=zl;zz/=zl;
  let xx=zy*0-zz*(-1), xy=zz*0-zx*0, xz=zx*(-1)-zy*0; // z cross up(0,-1,0)
  const xl=Math.hypot(xx,xy,xz)||1; xx/=xl;xy/=xl;xz/=xl;
  const yx=xy*zz-xz*zy, yy=xz*zx-xx*zz, yz=xx*zy-xy*zx;
  const V=[xx,yx,-zx,0, xy,yy,-zy,0, xz,yz,-zz,0,
   -(xx*cp[0]+xy*cp[1]+xz*cp[2]),
   -(yx*cp[0]+yy*cp[1]+yz*cp[2]),
    (zx*cp[0]+zy*cp[1]+zz*cp[2]),1];
  // P*V column-major
  const M=new Float32Array(16);
  for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
    for(let k2=0;k2<4;k2++)s+=P[k2*4+r]*V[c*4+k2];M[c*4+r]=s;}
  return M;
}
function buildIndex(){
  const idx=new Uint32Array((gh-1)*(gw-1)*6); let p=0;
  for(let r=0;r<gh-1;r++)for(let c=0;c<gw-1;c++){
    const a=r*gw+c,b=a+1,d=a+gw,e=d+1;
    idx[p++]=a;idx[p++]=d;idx[p++]=b; idx[p++]=b;idx[p++]=d;idx[p++]=e;}
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ibuf);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,idx,gl.STATIC_DRAW);
  nidx=idx.length;
}
async function loadFrame(n){
  const r=await fetch('/frame/'+n); if(!r.ok) return;
  const ab=await r.arrayBuffer(); const dv=new DataView(ab);
  if(dv.getUint32(0,true)!==0x4D445654) return;
  const h=dv.getUint16(4,true), w=dv.getUint16(6,true);
  cur.lo=[dv.getFloat32(8,true),dv.getFloat32(12,true),dv.getFloat32(16,true)];
  cur.span=[dv.getFloat32(20,true),dv.getFloat32(24,true),dv.getFloat32(28,true)];
  let off=32;
  const q=new Uint16Array(ab,off,h*w*3); off+=h*w*6;
  const c=new Uint8Array(ab,off,h*w*3); off+=h*w*3;
  frus=new Float32Array(ab.slice(off,off+96));
  if(h!==gh||w!==gw){gh=h;gw=w;buildIndex();}
  gl.bindBuffer(gl.ARRAY_BUFFER,qbuf);
  gl.bufferData(gl.ARRAY_BUFFER,q,gl.DYNAMIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER,cbuf);
  gl.bufferData(gl.ARRAY_BUFFER,c,gl.DYNAMIC_DRAW);
  document.getElementById('fno').textContent=n+'/'+(meta.frames-1);
  document.getElementById('seek').value=n;
}
function draw(){
  cv.width=innerWidth; cv.height=innerHeight;
  gl.viewport(0,0,cv.width,cv.height);
  gl.clearColor(0.06,0.07,0.09,1); gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.useProgram(prog);
  gl.uniformMatrix4fv(loc.mvp,false,mat());
  gl.uniform3fv(loc.lo,cur.lo); gl.uniform3fv(loc.span,cur.span);
  gl.uniform1f(loc.psz,3.0); gl.uniform1f(loc.noSent,0.0);
  if(gh){
    gl.bindBuffer(gl.ARRAY_BUFFER,qbuf);
    gl.enableVertexAttribArray(loc.aq);
    gl.vertexAttribPointer(loc.aq,3,gl.UNSIGNED_SHORT,false,0,0);
    gl.bindBuffer(gl.ARRAY_BUFFER,cbuf);
    gl.enableVertexAttribArray(loc.ac);
    gl.vertexAttribPointer(loc.ac,3,gl.UNSIGNED_BYTE,false,0,0);
    if(document.getElementById('mesh').checked){
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ibuf);
      gl.drawElements(gl.TRIANGLES,nidx,gl.UNSIGNED_INT,0);
    } else gl.drawArrays(gl.POINTS,0,gh*gw);
  }
  if(bg){
    gl.uniform3fv(loc.lo,bg.lo); gl.uniform3fv(loc.span,bg.span);
    gl.bindBuffer(gl.ARRAY_BUFFER,bg.q);
    gl.enableVertexAttribArray(loc.aq);
    gl.vertexAttribPointer(loc.aq,3,gl.UNSIGNED_SHORT,false,0,0);
    gl.bindBuffer(gl.ARRAY_BUFFER,bg.c);
    gl.enableVertexAttribArray(loc.ac);
    gl.vertexAttribPointer(loc.ac,3,gl.UNSIGNED_BYTE,false,0,0);
    gl.drawArrays(gl.POINTS,0,bg.n);
  }
  if(frus&&document.getElementById('frus').checked){
    gl.uniform3fv(loc.lo,[0,0,0]); gl.uniform3fv(loc.span,[1,1,1]);
    gl.uniform1f(loc.noSent,1.0); // raw floats: skip u16 invalid test
    const E=[0,1,1,2,2,3,3,0,4,5,5,6,6,7,7,4,0,4,1,5,2,6,3,7];
    const L=new Float32Array(E.length*3);
    for(let i=0;i<E.length;i++){L[i*3]=frus[E[i]*3]*65534;
      L[i*3+1]=frus[E[i]*3+1]*65534;L[i*3+2]=frus[E[i]*3+2]*65534;}
    // reuse quantized path: feed raw floats scaled as if quantized
    gl.bindBuffer(gl.ARRAY_BUFFER,fbuf);
    gl.bufferData(gl.ARRAY_BUFFER,L,gl.DYNAMIC_DRAW);
    gl.enableVertexAttribArray(loc.aq);
    gl.vertexAttribPointer(loc.aq,3,gl.FLOAT,false,0,0);
    const C=new Uint8Array(E.length*3); C.fill(70);
    for(let i=0;i<E.length;i++)C[i*3]=255;
    gl.bindBuffer(gl.ARRAY_BUFFER,fcol);
    gl.bufferData(gl.ARRAY_BUFFER,C,gl.DYNAMIC_DRAW);
    gl.enableVertexAttribArray(loc.ac);
    gl.vertexAttribPointer(loc.ac,3,gl.UNSIGNED_BYTE,false,0,0);
    gl.drawArrays(gl.LINES,0,E.length);
  }
  requestAnimationFrame(draw);
}
async function tick(ts){
  if(playing && meta && ts-last > 1000/meta.fps){
    last=ts; frame=(frame+1)%meta.frames; await loadFrame(frame);
  }
  requestAnimationFrame(tick);
}
let drag=null;
cv.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY,e.shiftKey];});
addEventListener('mouseup',()=>{drag=null;});
addEventListener('mousemove',e=>{
  if(!drag)return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){const s=cam.d*0.002;
    cam.tgt[0]-=dx*s*Math.cos(cam.th); cam.tgt[2]-=dx*s*Math.sin(cam.th);
    cam.tgt[1]-=dy*s;}
  else {cam.th+=dx*0.005; cam.ph=Math.max(-1.5,Math.min(1.5,cam.ph+dy*0.005));}
  drag=[e.clientX,e.clientY,drag[2]];
});
cv.addEventListener('wheel',e=>{cam.d*=Math.exp(e.deltaY*0.001);
  e.preventDefault();},{passive:false});
document.getElementById('play').onclick=()=>{playing=!playing;
  document.getElementById('play').innerHTML=playing?'&#10074;&#10074;':'&#9654;';};
document.getElementById('seek').oninput=async e=>{
  frame=parseInt(e.target.value); playing=false; await loadFrame(frame);};
(async()=>{
  meta=await (await fetch('/api/meta')).json();
  document.getElementById('seek').max=meta.frames-1;
  document.getElementById('info').textContent=
    meta.width+'x'+meta.height+' @'+meta.fps.toFixed(1)+'fps, grid '+
    meta.grid[0]+'x'+meta.grid[1];
  if(meta.background){
    const ab=await (await fetch('/background')).arrayBuffer();
    const dv=new DataView(ab);
    const n=dv.getUint32(0,true);
    const lo=[dv.getFloat32(4,true),dv.getFloat32(8,true),dv.getFloat32(12,true)];
    const span=[dv.getFloat32(16,true),dv.getFloat32(20,true),dv.getFloat32(24,true)];
    const q=gl.createBuffer(), c=gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER,q);
    gl.bufferData(gl.ARRAY_BUFFER,new Uint16Array(ab,28,n*3),gl.STATIC_DRAW);
    gl.bindBuffer(gl.ARRAY_BUFFER,c);
    gl.bufferData(gl.ARRAY_BUFFER,new Uint8Array(ab,28+n*6,n*3),gl.STATIC_DRAW);
    bg={q:q,c:c,n:n,lo:lo,span:span};
  }
  await loadFrame(0);
  requestAnimationFrame(draw); requestAnimationFrame(tick);
})();
</script></body></html>
"""


def _pack_background(path, max_points=1_000_000):
    """A background PLY as the page's blob: u32 count, f32 bbox_min[3],
    f32 bbox_scale[3], then u16 positions and u8 colors; at most
    ``max_points`` points, drawn with a seeded generator."""
    pts, cols = pcio.read_ply(path)
    if cols is None:
        cols = np.full_like(pts, 128.0)
    if pts.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(pts.shape[0], max_points,
                                              replace=False)
        pts, cols = pts[sel], cols[sel]
    lo = pts.min(0)
    span = np.maximum(pts.max(0) - lo, 1e-6)
    q16 = np.minimum(((pts - lo) / span * 65534.0).astype(np.uint16), 65534)
    head = struct.pack("<I", pts.shape[0])
    head += struct.pack("<6f", *lo.tolist(), *span.tolist())
    return (head + q16.astype("<u2").tobytes()
            + np.clip(cols, 0, 255).astype(np.uint8).tobytes())


def make_handler(src: FrameSource, background_blob=None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body, ctype):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                self._send(PAGE.encode(), "text/html")
            elif url.path == "/api/meta":
                self._send(json.dumps({
                    "frames": src.frame_count, "fps": src.fps,
                    "width": src.w, "height": src.h,
                    "grid": [src.gh, src.gw],
                    "background": background_blob is not None,
                }).encode(), "application/json")
            elif url.path == "/background" and background_blob is not None:
                self._send(background_blob, "application/octet-stream")
            elif url.path.startswith("/frame/"):
                try:
                    n = int(url.path.rsplit("/", 1)[1])
                except ValueError:
                    self.send_error(400)
                    return
                blob = (src.frame_payload(n)
                        if 0 <= n < max(src.frame_count, 1) else None)
                if blob is None:
                    self.send_error(404)
                else:
                    self._send(blob, "application/octet-stream")
            else:
                self.send_error(404)

    return Handler


def _server(depth_video, color_video, port, background_ply, source_kwargs):
    src = FrameSource(depth_video, color_video, **source_kwargs)
    bg = _pack_background(background_ply) if background_ply else None
    return ThreadingHTTPServer(("127.0.0.1", port),
                               make_handler(src, bg)), src


def serve(depth_video, color_video=None, port=8124, open_browser=False,
          background_ply=None, **source_kwargs):
    """Serve the viewer until interrupted. ``source_kwargs`` go to
    :class:`FrameSource` (``device`` among them); ``open_browser`` is
    accepted and not used, as in the JAX package. -> the server"""
    del open_browser
    srv, src = _server(depth_video, color_video, port, background_ply,
                       source_kwargs)
    print(f"MDVT 3D viewer: http://127.0.0.1:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        src.close()
    return srv


def serve_background(depth_video, color_video=None, port=0,
                     background_ply=None, **source_kwargs):
    """The viewer on a free port (``port`` 0) in a daemon thread. ->
    (server, source, port); stop it with ``server.shutdown()``,
    ``server.server_close()`` and ``source.close()``."""
    srv, src = _server(depth_video, color_video, port, background_ply,
                       source_kwargs)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, src, srv.server_address[1]
