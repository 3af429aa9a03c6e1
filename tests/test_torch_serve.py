"""The port's HTTP service (`migan_tpu_torch/cli/serve.py`) on the CPU:
`tests/test_serve.py`'s checks on the port, at res 64, with the generator
from the port's `load_model(..., device="cpu")` (the kernel chain's plain
versions), in both modes: healthz, composite semantics, parity with the
port's demo loop (at most 1 uint8), concurrent micro-batching, pipeline
served == direct, the oversize bucket, 400 / 404. And the same requests
served by the JAX package's server and the port's, on the same weights:
the replies are within 1 uint8.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import jax
import torch
from PIL import Image

from migan_tpu.io.checkpoint import save_npz as j_save_npz
from migan_tpu.models.migan_inference import (
    GeneratorConfig as JConfig, generator_init as j_init,
)
from migan_tpu_torch.cli import serve
from migan_tpu_torch.cli.demo import load_model

RES = 64


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One .npz of the JAX package's migan-64, read by both servers."""
    path = str(tmp_path_factory.mktemp("w") / "migan64.npz")
    j_save_npz(path, j_init(jax.random.PRNGKey(0), JConfig(resolution=RES)))
    return path


def _start(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv.server_address[1]


def _stop(srv, batcher):
    srv.shutdown()
    batcher.close()
    srv.server_close()


@pytest.fixture(scope="module")
def server(weights):
    forward, res = load_model("migan-64", weights, "float32", "cpu")
    srv, batcher = serve.make_server(forward, res, "127.0.0.1", 0,
                                     "migan-64", max_batch=4,
                                     window_ms=50.0)
    yield _start(srv), batcher, forward
    _stop(srv, batcher)


@pytest.fixture(scope="module")
def pipeline_server(weights):
    from migan_tpu_torch.export.pipeline import (
        make_pipeline, make_pipeline_stages,
    )

    forward, res = load_model("migan-64", weights, "float32", "cpu")
    runner = serve.PipelineRunner(
        make_pipeline_stages(res, device="cpu"),
        serve.MicroBatcher(forward, res, max_batch=4, window_ms=50.0), [96])
    srv, returned = serve.make_server(forward, res, "127.0.0.1", 0,
                                      "migan-64", pipeline_runner=runner)
    assert returned is runner
    yield _start(srv), runner, make_pipeline(forward, res, device="cpu")
    _stop(srv, runner)


def _png_b64(arr, mode=None):
    img = Image.fromarray(arr) if mode is None else \
        Image.fromarray(arr).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _make_pair(seed=0, size=(64, 64)):
    rng = np.random.RandomState(seed)
    h, w = size
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    mask = np.full((h, w), 255, np.uint8)
    mask[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = 0
    return img, mask


def _inpaint(port, img, mask, timeout=120):
    body = json.dumps({"image": _png_b64(img),
                       "mask": _png_b64(mask, "L")}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/inpaint", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "image/png"
        return np.asarray(Image.open(io.BytesIO(resp.read())))


def _healthz(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=30) as resp:
        return json.loads(resp.read())


def _concurrently(fn, n):
    results, errors = [None] * n, []

    def _client(i):
        try:
            results[i] = fn(i)
        except Exception as e:  # pragma: no cover
            errors.append((i, e))

    threads = [threading.Thread(target=_client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    return results


def _u8_diff(a, b) -> int:
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def test_healthz(server):
    info = _healthz(server[0])
    assert info["status"] == "ok"
    assert info["model"] == "migan-64"
    assert info["resolution"] == RES
    assert info["mode"] == "resize"


def test_single_request_composite_semantics(server):
    img, mask = _make_pair(seed=1)
    got = _inpaint(server[0], img, mask)
    assert got.shape == (64, 64, 3)
    known = mask == 255
    assert np.array_equal(got[known], img[known]), "known region kept"
    assert not np.array_equal(got[~known], img[~known]), "hole painted"


def test_parity_with_demo_loop(server):
    """The served composite equals the port's demo per-image loop on the
    same weights, within 1 uint8."""
    from migan_tpu_torch.data.preprocess import (
        postprocess, preprocess, read_mask_image, resize_max,
    )

    port, _, forward = server
    img, mask = _make_pair(seed=2)
    got = _inpaint(port, img, mask)
    img_r = resize_max(Image.fromarray(img), max_size=RES)
    mask_r = resize_max(read_mask_image(Image.fromarray(mask).convert("L")),
                        max_size=RES, interpolation=Image.NEAREST)
    y = forward(preprocess(img_r, mask_r, RES)).numpy()[0]
    want = np.asarray(postprocess(y, img_r, mask_r))
    assert _u8_diff(got, want) <= 1


def test_concurrent_requests_micro_batch(server):
    """8 concurrent clients against max_batch 4 / a 50 ms window give at
    least one dispatch of more than one row, and every client its own
    composite."""
    port, batcher = server[0], server[1]
    batcher.warmup()
    n0 = len(batcher.batch_sizes_served)
    pairs = [_make_pair(seed=10 + i) for i in range(8)]
    results = _concurrently(lambda i: _inpaint(port, *pairs[i]), 8)
    for i, (img, mask) in enumerate(pairs):
        known = mask == 255
        assert np.array_equal(results[i][known], img[known]), f"client {i}"
    served = batcher.batch_sizes_served[n0:]
    assert sum(served) == 8
    assert max(served) > 1, f"expected micro-batching, got batches {served}"


def test_pipeline_serve_arbitrary_size_parity(pipeline_server):
    """A non-square request of no bucket's size keeps its size and the
    pixels outside the crop box, and equals the port's pipeline run
    directly at the same bucket padding."""
    port, runner, pipeline = pipeline_server
    h, w = 80, 70
    rng = np.random.RandomState(5)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    mask = np.full((h, w), 255, np.uint8)
    mask[20:44, 15:39] = 0
    got = _inpaint(port, img, mask)
    assert got.shape == (h, w, 3)
    b = runner.bucket_for(h, w)
    assert b == 96
    pi = np.zeros((1, b, b, 3), np.uint8)
    pm = np.full((1, b, b, 1), 255, np.uint8)
    pi[0, :h, :w] = img
    pm[0, :h, :w, 0] = mask
    want = pipeline(pi, pm).numpy()[0, :h, :w]
    assert np.array_equal(got, want), "served != direct pipeline"
    assert not np.array_equal(got[20:44, 15:39], img[20:44, 15:39])


def test_pipeline_serve_oversize_rolls_up_bucket(pipeline_server):
    port, runner, _ = pipeline_server
    assert runner.bucket_for(100, 97) == 192
    h, w = 100, 97
    rng = np.random.RandomState(6)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    mask = np.full((h, w), 255, np.uint8)
    mask[30:60, 40:70] = 0
    got = _inpaint(port, img, mask)
    assert got.shape == (h, w, 3)
    assert not np.array_equal(got[30:60, 40:70], img[30:60, 40:70])
    assert 192 in runner.bucket_counts


def test_pipeline_concurrent_requests_batch_generator(pipeline_server):
    """Concurrent pipeline requests of different sizes share batched
    generator forwards; each keeps its known pixels away from the
    feathered edge of its hole."""
    port, runner, _ = pipeline_server
    runner.warmup()
    n0 = len(runner.batcher.batch_sizes_served)
    sizes = [(80, 70), (64, 96), (90, 90), (70, 80), (96, 64), (85, 75)]
    pairs = [_make_pair(seed=40 + i, size=s) for i, s in enumerate(sizes)]
    results = _concurrently(lambda i: _inpaint(port, *pairs[i]), len(pairs))
    for i, (img, mask) in enumerate(pairs):
        assert results[i].shape == img.shape, f"client {i}"
        h, w = mask.shape
        far = np.array(mask == 255)
        far[max(0, h // 4 - 4):3 * h // 4 + 4,
            max(0, w // 4 - 4):3 * w // 4 + 4] = False
        assert np.array_equal(results[i][far], img[far]), f"client {i}"
        assert not np.array_equal(results[i][mask == 0], img[mask == 0])
    served = runner.batcher.batch_sizes_served[n0:]
    assert max(served) > 1, f"expected batched G dispatches, got {served}"


def test_pipeline_healthz_reports_mode(pipeline_server):
    info = _healthz(pipeline_server[0])
    assert info["mode"] == "pipeline"
    assert info["buckets"] == [96]
    assert info["requests_served"] >= 1
    assert "96" in info["bucket_counts"]


def test_bad_request_and_404(server):
    port = server[0]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/inpaint", data=b"not json",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    for path in ("/nope", "/inpaint"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                   timeout=30)
        assert ei.value.code == 404


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["resize", "pipeline"])
def test_jax_and_port_servers_agree(weights, pipeline):
    """The same requests to the JAX package's server and the port's, on
    the same .npz: every reply within 1 uint8."""
    from migan_tpu.cli import demo as j_demo, serve as j_serve
    from migan_tpu.export.pipeline import make_pipeline_stages as j_stages
    from migan_tpu_torch.export.pipeline import make_pipeline_stages

    servers = []
    for mod, (fwd, res) in (
            (j_serve, j_demo.load_model("migan-64", weights)),
            (serve, load_model("migan-64", weights, "float32", "cpu"))):
        runner = None
        if pipeline:
            stages = (j_stages(res) if mod is j_serve
                      else make_pipeline_stages(res, device="cpu"))
            runner = mod.PipelineRunner(
                stages, mod.MicroBatcher(fwd, res, max_batch=1), [96])
        srv, b = mod.make_server(fwd, res, "127.0.0.1", 0, "migan-64",
                                 max_batch=1, pipeline_runner=runner)
        servers.append((srv, b, _start(srv)))
    try:
        sizes = [(80, 70), (96, 64)] if pipeline else [(64, 64), (90, 50)]
        for i, size in enumerate(sizes):
            img, mask = _make_pair(seed=60 + i, size=size)
            want, got = (_inpaint(port, img, mask)
                         for _, _, port in servers)
            # resize mode shrinks the larger side to the resolution
            scale = 1.0 if pipeline else min(1.0, RES / max(size))
            h, w = (int(s * scale) for s in size)
            assert got.shape == want.shape == (h, w, 3)
            assert _u8_diff(got, want) <= 1, f"request {i}"
    finally:
        for srv, b, _ in servers:
            _stop(srv, b)


def _body(seed):
    img, mask = _make_pair(seed=seed)
    return json.dumps({"image": _png_b64(img),
                       "mask": _png_b64(mask, "L")}).encode()


def test_loadgen_drives_the_server(server, tmp_path):
    """`python -m migan_tpu_torch.cli.loadgen` against the port's server:
    it sends warm-up + windows + one request per client, every one served;
    p99 is null below 100 replies a window. A wrong path fails every
    request and exits 1."""
    import os
    import subprocess
    import sys

    port, batcher = server[0], server[1]
    path = tmp_path / "bodies.jsonl"
    path.write_bytes(b"\n".join(_body(40 + i) for i in range(3)) + b"\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def loadgen(url_path):
        r = subprocess.run(
            [sys.executable, "-m", "migan_tpu_torch.cli.loadgen", "--url",
             f"http://127.0.0.1:{port}{url_path}", "--bodies", str(path),
             "--concurrency", "3", "--warmup", "2", "--requests", "4",
             "--repeats", "2"], cwd=repo, capture_output=True, text=True,
            timeout=300)
        return r.returncode, json.loads(r.stdout.strip().splitlines()[-1])

    n0 = sum(batcher.batch_sizes_served)
    rc, out = loadgen("/inpaint")
    assert rc == 0 and out["n_errors"] == 0, out
    assert out["sent"] == 2 + 2 * 4 + 3
    assert sum(batcher.batch_sizes_served) - n0 == out["sent"]
    assert [w["requests"] for w in out["windows"]] == [4, 4]
    for w in out["windows"]:
        assert w["requests_per_s"] > 0 and w["p50_ms"] > 0
        assert w["p99_ms"] is None
    rc, out = loadgen("/nope")
    assert rc == 1 and out["n_errors"] == out["sent"] == 13
    assert out["windows"] == []


def test_loadgen_windows_and_percentiles():
    """In process against a stub server: windows of 100 replies give a
    p99, each window's rate counts its own replies, and the nearest-rank
    percentile picks the value it should."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from migan_tpu_torch.cli import loadgen

    class Ok(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Ok)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        out = loadgen.run(f"http://127.0.0.1:{srv.server_address[1]}/",
                          [b"{}"], concurrency=4, warmup=5, requests=100,
                          repeats=2)
    finally:
        srv.shutdown()
        srv.server_close()
    assert out["n_errors"] == 0 and out["sent"] == 5 + 200 + 4
    for w in out["windows"]:
        assert w["requests"] == 100
        assert w["p99_ms"] is not None and w["p99_ms"] >= w["p50_ms"] > 0
        assert w["requests_per_s"] == pytest.approx(100 / w["seconds"])
    vals = list(range(1, 129))
    assert loadgen._rank(vals, 0.5) == 64 and loadgen._rank(vals, 0.99) == 127
