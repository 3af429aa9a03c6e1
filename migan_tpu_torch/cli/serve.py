"""HTTP inpainting service on the port (port of `migan_tpu/cli/serve.py`):
the generator behind HTTP with device micro-batching, so that concurrent
clients share batched forwards through the kernel chain.

    python -m migan_tpu_torch.cli.serve --model-name migan-512 \
        --model-path weights.npz --port 8080 --device cuda

Protocol (standard library on both ends), as the JAX package's:
  GET  /healthz  -> {"status": "ok", "model": ..., "resolution": ...,
                     "mode", "requests_served", "dispatches", "mean_batch"}
  POST /inpaint  -> image/png composite
      body: JSON {"image": <base64 PNG/JPEG>, "mask": <base64 PNG>,
                  "invert_mask": false}
      255 = known, anything below 255 = hole (binarised as the demo does).

Batching: one model thread drains up to --max-batch queued requests per
forward (waiting at most --batch-window-ms for followers after the first),
zero-pads to the next power of two, and hands each row back. Decoding and
encoding run on the HTTP handler threads and overlap the device.

Pipeline mode (--pipeline): requests go through the app pipeline
(`export/pipeline.py`: box crop, generator, feathered composite at the
image's own size). Images are padded into square size buckets (--buckets;
the padding is known pixels, so the box never grows into it); an image
larger than every bucket rounds up to a multiple of the largest. Crop and
composite run per request on the handler threads; the generator forward,
whose [N, res, res, 4] input does not depend on the image's size, goes
through the same micro-batcher, so requests of any sizes share forwards.

Every launch goes on the device's current stream. Rows cross threads only
as CPU numpy arrays, after `.cpu()`.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import threading
import time

import numpy as np

from ..data.preprocess import preprocess, read_mask_image, resize_max


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-name", required=True,
                   help="migan-<resolution>, e.g. migan-256 or migan-512")
    p.add_argument("--model-path", required=True,
                   help="Weights (.npz of migan_tpu or .pt state_dict).")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no card is "
                   "present.")
    p.add_argument("--max-batch", type=int, default=16,
                   help="Largest device batch; requests beyond it wait for "
                   "the next dispatch.")
    p.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="How long the batcher waits for follower requests "
                   "after the first one in a batch.")
    p.add_argument("--warmup", action="store_true",
                   help="Build the kernels and run every batch bucket (and "
                   "in pipeline mode every size bucket) before accepting "
                   "traffic.")
    p.add_argument("--pipeline", action="store_true",
                   help="Serve the full app pipeline (bbox crop + feathered "
                   "composite at original size) instead of whole-image "
                   "resize; accepts arbitrary image sizes.")
    p.add_argument("--buckets", default="512,1024",
                   help="Pipeline mode: comma-separated square size buckets "
                   "images are padded to.")
    return p.parse_args(argv)


class _Request:
    __slots__ = ("x", "event", "result", "error")

    def __init__(self, x):
        self.x = x            # [1, res, res, 4] float32 numpy
        self.event = threading.Event()
        self.result = None    # [res, res, 3] float32 numpy in [-1, 1]
        self.error = None


class MicroBatcher:
    """One model thread draining a request queue into bucketed batches.

    Buckets are powers of two up to max_batch; tail rows are zeros (the
    generator is convolutional, so rows are independent). The kernels'
    tile plans depend on N, so a row need not be bit-equal across batch
    sizes."""

    def __init__(self, forward, resolution: int, max_batch: int = 16,
                 window_ms: float = 2.0):
        self.forward = forward
        self.resolution = resolution
        self.max_batch = max(1, max_batch)
        self.window_s = max(0.0, window_ms) / 1e3
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self.batch_sizes_served: list = []  # observability
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="migan-batcher")
        self._thread.start()

    def submit(self, x: np.ndarray) -> _Request:
        req = _Request(x)
        self.queue.put(req)
        return req

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def warmup(self):
        """Run every bucket once on zeros (builds the kernels on a card)."""
        b = 1
        while True:
            x = np.zeros((b, self.resolution, self.resolution, 4),
                         np.float32)
            self.forward(x).cpu()
            if b >= self.max_batch:
                break
            b = min(b * 2, self.max_batch)

    def _drain(self):
        reqs = [self.queue.get(timeout=0.1)]
        deadline = time.perf_counter() + self.window_s
        while len(reqs) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                reqs.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return reqs

    def _run(self):
        while not self._stop.is_set():
            try:
                reqs = self._drain()
            except queue.Empty:
                continue
            try:
                bucket = self._bucket(len(reqs))
                xs = [r.x for r in reqs]
                pad = bucket - len(xs)
                if pad:
                    xs += [np.zeros_like(xs[0])] * pad
                y = self.forward(np.concatenate(xs, axis=0)).cpu().numpy()
                self.batch_sizes_served.append(len(reqs))
                for i, r in enumerate(reqs):
                    r.result = y[i]
                    r.event.set()
            except Exception as e:  # surface device errors to the client
                for r in reqs:
                    r.error = f"{type(e).__name__}: {e}"
                    r.event.set()


class PipelineRunner:
    """The app pipeline over size buckets, with a batched generator stage.

    Each request runs pre (box crop + resize to the model's resolution)
    and post (paste + feathered composite) on its own thread, while its
    generator forward goes to the shared MicroBatcher. Images pad to the
    smallest bucket that fits (mask padding = 255 = known, so the box and
    the generator input equal those at the exact size whenever the clamped
    box stays inside the image); oversize images round up to a multiple of
    the largest bucket."""

    def __init__(self, stages, batcher: "MicroBatcher", buckets):
        self.pre, self.post = stages
        self.batcher = batcher
        self.buckets = sorted(int(b) for b in buckets)
        if not self.buckets:
            raise ValueError("pipeline mode needs at least one size bucket")
        self._lock = threading.Lock()    # stats only
        self.bucket_counts: dict = {}    # bucket -> requests served

    def close(self):
        self.batcher.close()

    def bucket_for(self, h: int, w: int) -> int:
        m = max(h, w)
        for b in self.buckets:
            if b >= m:
                return b
        step = self.buckets[-1]
        return ((m + step - 1) // step) * step

    def warmup(self):
        """Run every size bucket's pre/post (no-hole masks) and every
        generator batch bucket."""
        res = self.batcher.resolution
        for b in self.buckets:
            img = np.zeros((1, b, b, 3), np.uint8)
            mask = np.full((1, b, b, 1), 255, np.uint8)
            _, box4 = self.pre(img, mask)
            self.post(img, mask, np.zeros((1, res, res, 3), np.float32),
                      box4).cpu()
        self.batcher.warmup()

    def run(self, img_np: np.ndarray, mask_np: np.ndarray) -> np.ndarray:
        """img_np [H, W, 3] uint8, mask_np [H, W] uint8 binarised (255 =
        known) -> composited [H, W, 3] uint8."""
        h, w = img_np.shape[:2]
        b = self.bucket_for(h, w)
        pi = np.zeros((1, b, b, 3), np.uint8)
        pm = np.full((1, b, b, 1), 255, np.uint8)
        pi[0, :h, :w] = img_np
        pm[0, :h, :w, 0] = mask_np
        x, box4 = self.pre(pi, pm)
        req = self.batcher.submit(x.cpu().numpy())
        req.event.wait()
        if req.error is not None:
            raise RuntimeError(req.error)
        out = self.post(pi, pm, req.result[None], box4).cpu().numpy()
        with self._lock:
            self.bucket_counts[b] = self.bucket_counts.get(b, 0) + 1
        return out[0, :h, :w]


def _decode_pipeline_request(body: bytes):
    """JSON body -> (img [H, W, 3] uint8, mask [H, W] uint8 binarised).

    No resizing: pipeline mode keeps the image's pixels. A mask of another
    size than the image is NEAREST-resized to it."""
    from PIL import Image

    payload = json.loads(body)
    img = Image.open(io.BytesIO(base64.b64decode(payload["image"])))
    img = img.convert("RGB")
    mask = Image.open(io.BytesIO(base64.b64decode(payload["mask"])))
    mask = read_mask_image(mask, invert=bool(payload.get("invert_mask")))
    if mask.size != img.size:
        mask = mask.resize(img.size, Image.NEAREST)
    return np.asarray(img, np.uint8), np.asarray(mask, np.uint8)


def _decode_request(body: bytes, resolution: int):
    """JSON body -> (x [1, res, res, 4], img_resized PIL, mask_resized
    PIL)."""
    from PIL import Image

    payload = json.loads(body)
    img = Image.open(io.BytesIO(base64.b64decode(payload["image"])))
    img = img.convert("RGB")
    mask = Image.open(io.BytesIO(base64.b64decode(payload["mask"])))
    img_resized = resize_max(img, max_size=resolution)
    mask = read_mask_image(mask, invert=bool(payload.get("invert_mask")))
    mask_resized = resize_max(mask, max_size=resolution,
                              interpolation=Image.NEAREST)
    x = preprocess(img_resized, mask_resized, resolution)
    return x, img_resized, mask_resized


def make_server(forward, resolution: int, host: str, port: int,
                model_name: str, *, max_batch: int = 16,
                window_ms: float = 2.0, pipeline_runner=None):
    """Build (ThreadingHTTPServer, MicroBatcher | PipelineRunner); the
    caller runs serve_forever() and owns shutdown. With a
    `pipeline_runner`, /inpaint goes through the app pipeline and its own
    batcher serves the forwards."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from ..data.preprocess import postprocess

    batcher = (pipeline_runner.batcher if pipeline_runner is not None
               else MicroBatcher(forward, resolution, max_batch=max_batch,
                                 window_ms=window_ms))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; stats via /healthz
            pass

        def _send(self, code: int, content_type: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, "text/plain", b"not found")
                return
            info = {"status": "ok", "model": model_name,
                    "resolution": resolution}
            served = batcher.batch_sizes_served
            if pipeline_runner is not None:
                info["mode"] = "pipeline"
                info["buckets"] = pipeline_runner.buckets
                info["requests_served"] = sum(
                    pipeline_runner.bucket_counts.values())
                info["bucket_counts"] = {
                    str(k): v for k, v in
                    sorted(pipeline_runner.bucket_counts.items())}
            else:
                info["mode"] = "resize"
                info["requests_served"] = sum(served)
            info["dispatches"] = len(served)
            info["mean_batch"] = (round(sum(served) / len(served), 2)
                                  if served else 0.0)
            self._send(200, "application/json", json.dumps(info).encode())

        def _send_png(self, arr_or_img):
            from PIL import Image

            img = (arr_or_img if isinstance(arr_or_img, Image.Image)
                   else Image.fromarray(arr_or_img))
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            self._send(200, "image/png", buf.getvalue())

        def _bad_request(self, e: Exception):
            self._send(400, "text/plain",
                       f"bad request: {type(e).__name__}: {e}".encode())

        def _post_pipeline(self, body: bytes):
            try:
                img_np, mask_np = _decode_pipeline_request(body)
            except Exception as e:
                self._bad_request(e)
                return
            try:
                out = pipeline_runner.run(img_np, mask_np)
            except Exception as e:  # surface device errors to the client
                self._send(500, "text/plain",
                           f"{type(e).__name__}: {e}".encode())
                return
            self._send_png(out)

        def do_POST(self):
            if self.path != "/inpaint":
                self._send(404, "text/plain", b"not found")
                return
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            if pipeline_runner is not None:
                self._post_pipeline(body)
                return
            try:
                x, img_resized, mask_resized = _decode_request(body,
                                                               resolution)
            except Exception as e:
                self._bad_request(e)
                return
            req = batcher.submit(x)
            req.event.wait()
            if req.error is not None:
                self._send(500, "text/plain", req.error.encode())
                return
            self._send_png(postprocess(req.result, img_resized,
                                       mask_resized))

    server = ThreadingHTTPServer((host, port), Handler)
    return server, (pipeline_runner if pipeline_runner is not None
                    else batcher)


def main(argv=None):
    args = get_args(argv)
    from .demo import load_model

    forward, resolution = load_model(args.model_name, args.model_path,
                                     args.dtype, args.device)
    runner = None
    if args.pipeline:
        from ..export.pipeline import make_pipeline_stages

        runner = PipelineRunner(
            make_pipeline_stages(resolution, device=args.device),
            MicroBatcher(forward, resolution, max_batch=args.max_batch,
                         window_ms=args.batch_window_ms),
            args.buckets.split(","))
    server, batcher = make_server(
        forward, resolution, args.host, args.port, args.model_name,
        max_batch=args.max_batch, window_ms=args.batch_window_ms,
        pipeline_runner=runner)
    if args.warmup:
        print("warming up "
              + ("pipeline size buckets..." if args.pipeline
                 else "batch buckets..."), flush=True)
        batcher.warmup()
    mode = (f"pipeline buckets {args.buckets}" if args.pipeline else
            f"max batch {args.max_batch}, window {args.batch_window_ms} ms")
    print(f"serving {args.model_name} on http://{args.host}:{args.port} "
          f"({mode}, {args.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.close()
        server.server_close()


if __name__ == "__main__":
    main()
