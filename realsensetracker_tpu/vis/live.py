"""Live viewer service: the RsViewer Loop analog (rs_viewer.cpp:67-117).

The reference's viewer polls the driver for frames, renders each fresh one
into an interactive SubprocessViewer window, sleeps interval/8 when the
frame is stale, and optionally records every rendered frame
(rs_viewer.cpp:82-112). A GPU server is headless, so the "window" here is an
HTTP service: `LiveServer` holds the latest rendered PNG and serves

  GET /           self-refreshing HTML page (the live view)
  GET /frame.png  latest frame
  GET /stream     multipart/x-mixed-replace PNG stream (MJPEG-style)
  GET /status     JSON side-channel (frame index, pose, fps)
  GET /orbit      INTERACTIVE 3-D point-cloud view (vanilla-WebGL orbit
                  camera: drag = rotate, wheel = zoom, shift-drag = pan)
                  -- the SubprocessViewer-window analog the PNG endpoints
                  could not give (rs_viewer.cpp:24,40)
  GET /cloud.bin  latest cloud snapshot, compact binary (pack_cloud)

plus an optional atomically-updated `latest.png` on disk for file
watchers. `viewer_loop` reproduces the exact Loop semantics over a
FrameStream source: poll -> render fresh frames -> sleep interval/8 when
stale -> record.

No third-party deps: PNG encoding is stdlib zlib, the server is
http.server in a daemon thread, and the orbit page is self-contained
vanilla JS/WebGL1 (zero-egress safe: no CDN).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib

import numpy as np

_INDEX_HTML = b"""<!doctype html>
<html><head><title>rs-viewer live</title><style>
body { background: #111; color: #ddd; font-family: monospace; margin: 1em; }
img { max-width: 100%; image-rendering: pixelated; }
</style></head><body>
<div id="status">connecting...</div>
<img id="view" src="/frame.png">
<script>
const img = document.getElementById('view');
const status = document.getElementById('status');
async function tick() {
  img.src = '/frame.png?t=' + Date.now();
  try {
    const s = await (await fetch('/status')).json();
    status.textContent = JSON.stringify(s);
  } catch (e) {}
}
setInterval(tick, 200);
</script>
<p><a href="/orbit" style="color:#8cf">3-D orbit view</a></p>
</body></html>
"""

# Interactive orbit viewer: self-contained WebGL1 point renderer. Camera
# model: yaw/pitch orbit around a target, wheel dolly, shift-drag pan.
# Clouds arrive as pack_cloud blobs; re-fetched when /status cloud_seq
# changes. Colorless clouds get a height (y) colormap in the shader.
_ORBIT_HTML = b"""<!doctype html>
<html><head><title>rs-viewer orbit</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:0; }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:6px; }
canvas { display:block; width:100vw; height:100vh; }
</style></head><body>
<div id="hud">drag: rotate &middot; wheel: zoom &middot; shift-drag: pan
<span id="n"></span></div>
<canvas id="gl"></canvas>
<script>
const canvas = document.getElementById('gl');
const gl = canvas.getContext('webgl');
const VS = `
attribute vec3 p; attribute vec3 c;
uniform mat4 mvp; uniform float psize; varying vec3 vc;
void main() {
  gl_Position = mvp * vec4(p, 1.0);
  gl_PointSize = max(psize / max(gl_Position.w, 0.1), 1.0);
  vc = c;
}`;
const FS = `
precision mediump float; varying vec3 vc;
void main() { gl_FragColor = vec4(vc, 1.0); }`;
function shader(type, src) {
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const locP = gl.getAttribLocation(prog, 'p');
const locC = gl.getAttribLocation(prog, 'c');
const locMvp = gl.getUniformLocation(prog, 'mvp');
const locSz = gl.getUniformLocation(prog, 'psize');
const bufP = gl.createBuffer(), bufC = gl.createBuffer();
const bufTP = gl.createBuffer(), bufTC = gl.createBuffer();
let nPts = 0, nTraj = 0, center = [0, 0, 1.5];

// Column-major 4x4 helpers (enough for a viewer: no library).
function mul(a, b) {
  const o = new Float32Array(16);
  for (let i = 0; i < 4; i++) for (let j = 0; j < 4; j++) {
    let s = 0;
    for (let k = 0; k < 4; k++) s += a[k * 4 + j] * b[i * 4 + k];
    o[i * 4 + j] = s;
  }
  return o;
}
function persp(fovy, aspect, near, far) {
  const f = 1 / Math.tan(fovy / 2), o = new Float32Array(16);
  o[0] = f / aspect; o[5] = f;
  o[10] = (far + near) / (near - far); o[11] = -1;
  o[14] = 2 * far * near / (near - far);
  return o;
}
function lookAt(eye, at, up) {
  const sub = (a, b) => [a[0] - b[0], a[1] - b[1], a[2] - b[2]];
  const norm = v => { const l = Math.hypot(...v) || 1; return v.map(x => x / l); };
  const cross = (a, b) => [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                           a[0] * b[1] - a[1] * b[0]];
  const dot = (a, b) => a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
  const z = norm(sub(eye, at)), x = norm(cross(up, z)), y = cross(z, x);
  return new Float32Array([
    x[0], y[0], z[0], 0, x[1], y[1], z[1], 0, x[2], y[2], z[2], 0,
    -dot(x, eye), -dot(y, eye), -dot(z, eye), 1]);
}

// Orbit state (y-down camera convention: start looking down +z).
let yaw = -1.7, pitch = -0.4, dist = 4.0, target = center.slice();
let drag = null;
canvas.addEventListener('mousedown', e => {
  drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey || e.button === 2};
});
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) {
    const s = dist * 0.0015;
    const cy = Math.cos(yaw), sy = Math.sin(yaw);
    target[0] -= (-sy) * dx * s; target[2] -= cy * dx * s;
    target[1] -= dy * s;
  } else {
    yaw += dx * 0.006;
    pitch = Math.max(-1.5, Math.min(1.5, pitch - dy * 0.006));
  }
});
canvas.addEventListener('wheel', e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001);
  dist = Math.max(0.1, Math.min(100, dist));
}, {passive: false});
canvas.addEventListener('contextmenu', e => e.preventDefault());

function draw() {
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if (canvas.width !== w || canvas.height !== h) {
    canvas.width = w; canvas.height = h;
  }
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.07, 0.07, 0.07, 1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const eye = [
    target[0] + dist * Math.cos(pitch) * Math.cos(yaw),
    target[1] + dist * Math.sin(pitch),
    target[2] + dist * Math.cos(pitch) * Math.sin(yaw)];
  // Depth-camera clouds are y-DOWN; up = -y keeps floors at the bottom.
  const mvp = mul(persp(0.9, w / h, 0.05, 200),
                  lookAt(eye, target, [0, -1, 0]));
  gl.uniformMatrix4fv(locMvp, false, mvp);
  gl.enableVertexAttribArray(locP);
  gl.enableVertexAttribArray(locC);
  if (nPts > 0) {
    gl.uniform1f(locSz, 6.0);
    gl.bindBuffer(gl.ARRAY_BUFFER, bufP);
    gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ARRAY_BUFFER, bufC);
    gl.vertexAttribPointer(locC, 3, gl.UNSIGNED_BYTE, true, 0, 0);
    gl.drawArrays(gl.POINTS, 0, nPts);
  }
  if (nTraj > 1) {
    gl.bindBuffer(gl.ARRAY_BUFFER, bufTP);
    gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ARRAY_BUFFER, bufTC);
    gl.vertexAttribPointer(locC, 3, gl.UNSIGNED_BYTE, true, 0, 0);
    gl.drawArrays(gl.LINE_STRIP, 0, nTraj);
  }
  requestAnimationFrame(draw);
}

function heightColors(xyz, n) {
  // Colorless clouds: blue (low y = ceiling, y-down) -> yellow (floor).
  let lo = 1e9, hi = -1e9;
  for (let i = 0; i < n; i++) {
    const y = xyz[3 * i + 1];
    if (y < lo) lo = y; if (y > hi) hi = y;
  }
  const span = Math.max(hi - lo, 1e-6), c = new Uint8Array(3 * n);
  for (let i = 0; i < n; i++) {
    const t = (xyz[3 * i + 1] - lo) / span;
    c[3 * i] = 40 + 210 * t; c[3 * i + 1] = 90 + 140 * t;
    c[3 * i + 2] = 240 - 200 * t;
  }
  return c;
}

let cloudSeq = -1;
async function fetchCloud() {
  try {
    const s = await (await fetch('/status')).json();
    if ((s.cloud_seq || 0) === cloudSeq) return;
    cloudSeq = s.cloud_seq || 0;
    const buf = await (await fetch('/cloud.bin?t=' + Date.now())).arrayBuffer();
    const dv = new DataView(buf);
    if (dv.getUint32(0, true) !== 0x31435352) return;  // 'RSC1'
    const n = dv.getUint32(4, true), hasC = dv.getUint8(8), t = dv.getUint32(12, true);
    let off = 16;
    const xyz = new Float32Array(buf, off, 3 * n); off += 12 * n;
    let rgb;
    if (hasC) { rgb = new Uint8Array(buf, off, 3 * n); off += 3 * n; }
    else rgb = heightColors(xyz, n);
    const traj = new Float32Array(buf.slice(off, off + 12 * t));
    gl.bindBuffer(gl.ARRAY_BUFFER, bufP);
    gl.bufferData(gl.ARRAY_BUFFER, xyz, gl.STATIC_DRAW);
    gl.bindBuffer(gl.ARRAY_BUFFER, bufC);
    gl.bufferData(gl.ARRAY_BUFFER, rgb, gl.STATIC_DRAW);
    nPts = n;
    if (t > 1) {
      const tc = new Uint8Array(3 * t).fill(255);  // white trail
      for (let i = 0; i < t; i++) tc[3 * i + 2] = 80;
      gl.bindBuffer(gl.ARRAY_BUFFER, bufTP);
      gl.bufferData(gl.ARRAY_BUFFER, traj, gl.STATIC_DRAW);
      gl.bindBuffer(gl.ARRAY_BUFFER, bufTC);
      gl.bufferData(gl.ARRAY_BUFFER, tc, gl.STATIC_DRAW);
    }
    nTraj = t;
    if (n > 0 && cloudSeq <= 1) {  // first cloud: frame it
      let m = [0, 0, 0];
      for (let i = 0; i < n; i++)
        for (let k = 0; k < 3; k++) m[k] += xyz[3 * i + k];
      target = m.map(x => x / n);
    }
    document.getElementById('n').textContent =
      ' | ' + n + ' pts, ' + t + ' poses';
  } catch (e) {}
}
setInterval(fetchCloud, 1000);
fetchCloud();
requestAnimationFrame(draw);
</script></body></html>
"""


def pack_cloud(points, colors=None, trajectory=None) -> bytes:
    """Compact binary cloud snapshot for the /orbit page.

    Layout (little endian): magic 'RSC1' | u32 N | u8 has_color | 3 pad |
    u32 T | N xyz f32 | [N rgb u8] | T trajectory-position xyz f32.
    Colors may be float in [0, 1] or uint8."""
    pts = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    n = pts.shape[0]
    has_c = colors is not None
    head = struct.pack("<4sIB3xI", b"RSC1", n, int(has_c),
                       0 if trajectory is None else len(trajectory))
    blob = [head, pts.tobytes()]
    if has_c:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0.0, 1.0) * 255).astype(np.uint8)
        c = np.ascontiguousarray(c.reshape(-1, 3))
        if c.shape[0] != n:
            raise ValueError(f"{c.shape[0]} colors for {n} points")
        blob.append(c.tobytes())
    if trajectory is not None:
        t = np.ascontiguousarray(
            np.asarray(trajectory, np.float32).reshape(-1, 3)
        )
        blob.append(t.tobytes())
    return b"".join(blob)


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (stdlib zlib only)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF
        )

    # Filter byte 0 (None) prepended to every scanline.
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


# Small viridis-like colormap (anchor colors, linearly interpolated).
_CMAP = np.asarray(
    [
        [68, 1, 84],
        [59, 82, 139],
        [33, 145, 140],
        [94, 201, 98],
        [253, 231, 37],
    ],
    np.float32,
)


def depth_to_rgb(depth: np.ndarray, max_depth: float = 5.0) -> np.ndarray:
    """Depth (H, W) meters -> (H, W, 3) uint8; invalid (<= 0, NaN/inf) is
    black. Non-finite pixels must be zeroed BEFORE the colormap index
    math: floor(NaN).astype(int32) is INT32_MIN, which would crash the
    _CMAP gather (and with it the whole viewer loop)."""
    d = np.asarray(depth, np.float32)
    d = np.where(np.isfinite(d), d, 0.0)
    t = np.clip(d / max_depth, 0.0, 1.0) * (len(_CMAP) - 1)
    lo = np.floor(t).astype(np.int32)
    hi = np.minimum(lo + 1, len(_CMAP) - 1)
    frac = (t - lo)[..., None]
    rgb = _CMAP[lo] * (1.0 - frac) + _CMAP[hi] * frac
    rgb[d <= 0.0] = 0.0
    return rgb.astype(np.uint8)


class LiveServer:
    """Thread-backed HTTP service holding the latest rendered frame."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._lock = threading.Condition()
        self._png: bytes = encode_png(np.zeros((2, 2, 3), np.uint8))
        self._seq = 0
        self._cloud: bytes = pack_cloud(np.zeros((0, 3), np.float32))
        self._cloud_seq = 0
        self._status: dict = {}
        server_self = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                # The index page polls /frame.png every 200 ms, so client
                # disconnects mid-write are ROUTINE -- swallow them instead
                # of letting socketserver dump a traceback per navigation.
                try:
                    self._do_get()
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _do_get(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _INDEX_HTML)
                elif path == "/frame.png":
                    with server_self._lock:
                        body = server_self._png
                    self._send(200, "image/png", body)
                elif path == "/status":
                    with server_self._lock:
                        st = dict(server_self._status)
                        st["cloud_seq"] = server_self._cloud_seq
                        body = json.dumps(st).encode()
                    self._send(200, "application/json", body)
                elif path == "/orbit":
                    self._send(200, "text/html", _ORBIT_HTML)
                elif path == "/cloud.bin":
                    with server_self._lock:
                        body = server_self._cloud
                    self._send(200, "application/octet-stream", body)
                elif path == "/stream":
                    # MJPEG-style multipart stream of PNGs: push every new
                    # frame as it arrives (the truly-live endpoint).
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    seen = -1
                    try:
                        while True:
                            with server_self._lock:
                                server_self._lock.wait_for(
                                    lambda: server_self._seq != seen, timeout=5.0
                                )
                                body, seen = server_self._png, server_self._seq
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png\r\n"
                                + f"Content-Length: {len(body)}\r\n\r\n".encode()
                            )
                            self.wfile.write(body + b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    self._send(404, "text/plain", b"not found")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def update(self, png: bytes, status: dict | None = None) -> None:
        with self._lock:
            self._png = png
            if status is not None:
                self._status = status
            self._seq += 1
            self._lock.notify_all()

    def update_cloud(self, points, colors=None, trajectory=None) -> None:
        """Publish a point-cloud snapshot to the /orbit page (pack_cloud
        args; pass a pre-packed bytes blob as ``points`` to skip packing)."""
        blob = points if isinstance(points, bytes) else pack_cloud(
            points, colors, trajectory
        )
        with self._lock:
            self._cloud = blob
            self._cloud_seq += 1
            self._lock.notify_all()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def write_latest_png(path: str, png: bytes) -> None:
    """Atomic latest-frame update (tmp + rename) for file watchers."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(png)
    os.replace(tmp, path)


def viewer_loop(
    stream,
    on_frame,
    frame_interval_s: float = 0.0,
    max_frames: int | None = None,
    sleep=time.sleep,
) -> int:
    """The Loop (rs_viewer.cpp:67-117): poll the source; STALE frames sleep
    interval/8 (rs_viewer.cpp:82-86); fresh frames go to on_frame(ts, frame)
    (render + record, :90-112). Returns the number of frames shown.

    stream: anything with .poll() -> (ts, frame) | None and .exhausted.
    """
    shown = 0
    stale_sleep = max(frame_interval_s / 8.0, 1e-3)
    while max_frames is None or shown < max_frames:
        item = stream.poll()
        if item is None:
            if stream.exhausted:
                break
            sleep(stale_sleep)
            continue
        on_frame(*item)
        shown += 1
    return shown
