"""Interactive browser viewer: the browser talks to this HTTP server, which
renders on a CUDA card through ``api.render_image_rgba`` and returns raw
RGBA frames.

    python -m nerf_rs_tpu_torch.serve --port 8400 --accel
    # then open http://localhost:8400
"""

from __future__ import annotations

import argparse
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

_PAGE = """<!doctype html>
<html><head><title>nerf_rs_tpu_torch viewer</title>
<style>
 body { font-family: system-ui, sans-serif; max-width: 640px; margin: 2rem auto; }
 canvas { border: 1px solid #ccc; image-rendering: pixelated; width: 512px; height: 512px; }
 button { padding: .5rem 1rem; margin-right: .5rem; }
</style></head>
<body>
<h2>nerf_rs_tpu_torch &mdash; lego scene, rendered on a CUDA GPU</h2>
<p><button id="render">Render</button> <span id="status"></span></p>
<canvas id="canvas" width="256" height="256"></canvas>
<script>
const btn = document.getElementById('render');
const status = document.getElementById('status');
let seed = 0;
btn.onclick = async () => {
  status.textContent = 'rendering on the GPU...';
  const t0 = performance.now();
  try {
    const resp = await fetch(`/render?width=256&height=256&seed=${seed++}`);
    if (!resp.ok) {
      status.textContent = `render failed (${resp.status}): ${await resp.text()}`;
      return;
    }
    const meta = JSON.parse(resp.headers.get('x-render-meta'));
    const buf = new Uint8ClampedArray(await resp.arrayBuffer());
    const ctx = document.getElementById('canvas').getContext('2d');
    ctx.putImageData(new ImageData(buf, meta.width, meta.height), 0, 0);
    status.textContent = `rendered in ${(performance.now()-t0).toFixed(0)} ms (device: ${meta.device_ms.toFixed(0)} ms)`;
  } catch (e) {
    status.textContent = `render failed: ${e}`;
  }
};
</script>
</body></html>
"""


class Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802
        url = urlparse(self.path)
        if url.path in ("/", "/index.html"):
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("content-type", "text/html")
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path == "/render":
            q = parse_qs(url.query)
            try:
                width = int(q.get("width", ["256"])[0])
                height = int(q.get("height", ["256"])[0])
                seed = int(q.get("seed", ["0"])[0])
            except ValueError:
                width = height = -1  # falls through to the 400 below
                seed = 0
            if not (0 < width <= 2048 and 0 < height <= 2048):
                msg = b"width/height/seed must be integers, size in 1..2048"
                self.send_response(400)
                self.send_header("content-length", str(len(msg)))
                self.end_headers()
                self.wfile.write(msg)
                return
            try:
                from nerf_rs_tpu_torch.api import render_image_rgba

                t0 = time.perf_counter()
                rgba = render_image_rgba(width, height, seed=seed)
                device_ms = (time.perf_counter() - t0) * 1e3
            except Exception as e:  # surface errors to the page
                msg = str(e).encode()
                self.send_response(500)
                self.send_header("content-length", str(len(msg)))
                self.end_headers()
                self.wfile.write(msg)
                return
            body = rgba.tobytes()
            self.send_response(200)
            self.send_header("content-type", "application/octet-stream")
            self.send_header("x-render-meta", json.dumps(
                {"width": width, "height": height, "device_ms": device_ms}))
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(404)
        self.end_headers()

    def log_message(self, fmt, *args):
        print(f"[serve] {fmt % args}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=8400)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on, e.g. cuda, cuda:1 or cpu")
    parser.add_argument("--warmup", action="store_true",
                        help="render one frame (and build the kernels) before serving")
    parser.add_argument("--accel", action="store_true",
                        help="serve through the occupancy-grid fast path "
                             "(one-time grid bake + per-size calibration)")
    parser.add_argument("--accel-res", type=int, default=128,
                        help="occupancy grid resolution per axis")
    parser.add_argument("--checkpoint",
                        help="serve a training checkpoint (any model family) instead of the "
                             "pretrained weights")
    args = parser.parse_args(argv)
    from nerf_rs_tpu_torch.api import init_renderer

    if args.accel:
        print(f"baking {args.accel_res}^3 occupancy grid...")
    init_renderer(accel=True if args.accel else None, accel_res=args.accel_res,
                  checkpoint=args.checkpoint, device=args.device)
    if args.warmup:
        from nerf_rs_tpu_torch.api import render_image_rgba

        print("warming up (first render)...")
        render_image_rgba(256, 256)
    server = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"serving on http://{args.host}:{args.port}")
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
