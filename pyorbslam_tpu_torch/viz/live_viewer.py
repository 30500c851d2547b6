"""Live map/frame viewer: the runtime equivalent of the reference's
pangolin Viewer thread (Viewer.py:40-147) over a small stdlib HTTP server.

Port of ``pyorbslam_tpu/viz/live_viewer.py``; the page and the state
snapshot are the JAX package's.  A single-page browser client renders:

  * the map: landmarks, keyframe frusta, covisibility edges, spanning
    tree, the live trajectory and current camera (MapDrawer.py:55-210);
  * the current frame with tracked-keypoint overlay and the status bar
    (FrameDrawer.py:21-120);
  * menu toggles (follow camera, show points / graph / keyframes)
    mirroring the reference's panel (Viewer.py:58-66).

The server runs on a daemon thread and reads only the ``System``'s host
state, without locks: the numpy stores (``landmarks.pos``,
``keyframes.Tcw``), the native covisibility, ``trajectory``, ``stats``,
the last frame's host snapshot (``_frame_cache[1]``) and
``_viewer_image``.  The store arrays are fixed-capacity and
single-writer, so a torn read shows a half-updated landmark for one
refresh tick at worst.  It never touches a device tensor (the last frame
is compared by identity only): a read from this thread would wait for
the tracker's CUDA stream.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>pyorbslam-tpu viewer</title><style>
body { margin:0; background:#111; color:#ddd; font:12px monospace; }
#bar { padding:4px 8px; background:#222; }
#bar label { margin-right: 12px; }
canvas { display:block; }
</style></head><body>
<div id="bar">
  <label><input type="checkbox" id="follow" checked>follow camera</label>
  <label><input type="checkbox" id="pts" checked>points</label>
  <label><input type="checkbox" id="kfs" checked>keyframes</label>
  <label><input type="checkbox" id="graph" checked>graph</label>
  <span id="status"></span>
</div>
<canvas id="map" width="900" height="540"></canvas>
<canvas id="frame" width="900" height="280"></canvas>
<script>
const mapC = document.getElementById('map'), mctx = mapC.getContext('2d');
const frC = document.getElementById('frame'), fctx = frC.getContext('2d');
let scale = 6.0, cx = 0, cz = 0;
async function tick() {
  try {
    const s = await (await fetch('state')).json();
    document.getElementById('status').textContent =
      ` ${s.status.state}  frame ${s.status.frame}  kfs ${s.status.kfs}` +
      `  lms ${s.status.lms}  inliers ${s.status.inliers}` +
      `  loops ${s.status.loops}`;
    if (document.getElementById('follow').checked && s.cam) {
      cx = s.cam[0]; cz = s.cam[1];
    }
    const W = mapC.width, H = mapC.height;
    const X = p => (p[0]-cx)*scale + W/2, Y = p => H/2 - (p[1]-cz)*scale;
    mctx.fillStyle = '#111'; mctx.fillRect(0, 0, W, H);
    if (document.getElementById('pts').checked) {
      mctx.fillStyle = '#3a6';
      for (const p of s.points) mctx.fillRect(X(p)-1, Y(p)-1, 2, 2);
    }
    if (document.getElementById('graph').checked) {
      mctx.strokeStyle = '#335'; mctx.beginPath();
      for (const e of s.covis) {
        mctx.moveTo(X(s.kf_xy[e[0]]), Y(s.kf_xy[e[0]]));
        mctx.lineTo(X(s.kf_xy[e[1]]), Y(s.kf_xy[e[1]]));
      }
      mctx.stroke();
    }
    if (document.getElementById('kfs').checked) {
      mctx.fillStyle = '#46f';
      for (const k of s.kf_xy) mctx.fillRect(X(k)-2, Y(k)-2, 4, 4);
    }
    mctx.strokeStyle = '#f80'; mctx.beginPath();
    s.traj.forEach((p, i) => i ? mctx.lineTo(X(p), Y(p))
                               : mctx.moveTo(X(p), Y(p)));
    mctx.stroke();
    if (s.cam) {
      mctx.fillStyle = '#fff';
      mctx.beginPath();
      mctx.arc(X(s.cam), Y(s.cam), 4, 0, 6.283); mctx.fill();
    }
    if (s.frame) {
      const img = new Image();
      img.onload = () => {
        fctx.drawImage(img, 0, 0, frC.width, frC.height);
        const sx = frC.width / s.frame_w, sy = frC.height / s.frame_h;
        fctx.fillStyle = '#3f6';
        for (const k of s.keypoints)
          fctx.fillRect(k[0]*sx-1, k[1]*sy-1, 3, 3);
      };
      img.src = 'data:image/bmp;base64,' + s.frame;
    }
  } catch (e) {}
  setTimeout(tick, 250);
}
tick();
</script></body></html>"""


def _gray_bmp_b64(img: np.ndarray, stride: int = 2) -> str:
    """Encode a u8 grayscale image as a base64 8-bit BMP (stdlib-only;
    browsers decode BMP natively).  ``stride`` downsamples for payload."""
    g = np.ascontiguousarray(img[::stride, ::stride])
    h, w = g.shape
    row = (w + 3) & ~3
    pad = row - w
    header = bytearray(54 + 1024)
    header[0:2] = b"BM"
    size = len(header) + row * h
    header[2:6] = size.to_bytes(4, "little")
    header[10:14] = len(header).to_bytes(4, "little")
    header[14:18] = (40).to_bytes(4, "little")
    header[18:22] = w.to_bytes(4, "little")
    header[22:26] = h.to_bytes(4, "little")
    header[26:28] = (1).to_bytes(2, "little")
    header[28:30] = (8).to_bytes(2, "little")
    header[34:38] = (row * h).to_bytes(4, "little")
    header[46:50] = (256).to_bytes(4, "little")
    for i in range(256):                      # grayscale palette
        header[54 + 4 * i: 54 + 4 * i + 3] = bytes((i, i, i))
    rows = g[::-1]                            # BMP is bottom-up
    if pad:
        rows = np.pad(rows, ((0, 0), (0, pad)))
    return base64.b64encode(bytes(header) + rows.tobytes()).decode()


class LiveViewer:
    """Start with ``LiveViewer(system).start()``; browse to
    http://localhost:<port>/ while the System tracks."""

    def __init__(self, system, port: int = 8765, max_points: int = 20000):
        self.system = system
        self.port = port
        self.max_points = max_points
        self._httpd = None
        self._thread = None

    # ---------------- state snapshot ----------------

    def state(self) -> dict:
        sysm = self.system
        m = sysm.map
        lm, ks = m.landmarks, m.keyframes
        n = lm.n
        alive = np.nonzero(lm.alive[:n])[0]
        if len(alive) > self.max_points:
            alive = alive[:: len(alive) // self.max_points + 1]
        pts = lm.pos[alive][:, [0, 2]]

        kf_ids = np.nonzero(ks.alive[: ks.n])[0]
        Twc_t = np.empty((len(kf_ids), 2), np.float32)
        for i, k in enumerate(kf_ids):
            T = ks.Tcw[k]
            c = -T[:3, :3].T @ T[:3, 3]
            Twc_t[i] = (c[0], c[2])
        slot = {int(k): i for i, k in enumerate(kf_ids)}
        covis = []
        for i, k in enumerate(kf_ids[-200:]):
            for nb in m.covisible_neighbors(int(k), 5):
                j = slot.get(int(nb))
                if j is not None:
                    covis.append((slot[int(k)], j))

        traj = [(float(T[0]), float(T[1]))
                for T in _centers(sysm.trajectory[-2000:])]
        cam = traj[-1] if traj else None

        st = sysm.stats[-1] if sysm.stats else {}
        out = dict(
            points=np.round(pts, 2).tolist(),
            kf_xy=np.round(Twc_t, 2).tolist(),
            covis=covis,
            traj=traj,
            cam=cam,
            status=dict(
                state=sysm.state, frame=int(sysm.frame_id),
                kfs=int(len(kf_ids)), lms=int(len(alive)),
                inliers=int(st.get("inliers", 0)),
                loops=(sysm.loop_closer.n_loops_closed
                       if sysm.loop_closer else 0),
            ),
        )
        frame = getattr(sysm, "last_frame", None)
        if frame is not None and getattr(sysm, "_frame_cache", None) \
                and sysm._frame_cache[0] is frame:
            snap = sysm._frame_cache[1]
            va = snap["valid"]
            out["keypoints"] = np.round(snap["xy"][va], 1).tolist()
        else:
            out["keypoints"] = []
        img = getattr(sysm, "_viewer_image", None)
        if img is not None:
            out["frame"] = _gray_bmp_b64(img)
            out["frame_w"] = img.shape[1] // 2
            out["frame_h"] = img.shape[0] // 2
        else:
            out["frame"] = None
        return out

    # ---------------- server ----------------

    def start(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.rstrip("/") in ("", "/index.html"):
                    body = _PAGE.encode()
                    ctype = "text/html"
                elif self.path.lstrip("/").startswith("state"):
                    try:
                        body = json.dumps(viewer.state()).encode()
                    except Exception as e:  # torn read: retry next tick
                        body = json.dumps(dict(error=str(e))).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop serving, close the socket and join the server thread."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None


def _centers(Tcws) -> np.ndarray:
    out = np.empty((len(Tcws), 2), np.float32)
    for i, T in enumerate(Tcws):
        c = -T[:3, :3].T @ T[:3, 3]
        out[i] = (c[0], c[2])
    return out
