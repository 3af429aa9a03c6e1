"""Each CUDA kernel of `migan_tpu_torch` against its plain PyTorch version on
the card: float32 with TF32 off at odd sizes that leave ragged tiles, and
every kernel at every main-path shape of migan-512 in float32 and
bfloat16.

Marked `cuda`: skips where no CUDA device is present. This file imports
no JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances: float32 rtol/atol 1e-4, the same float32 sums in another order
(the kernels' three-pass TF32 product keeps ~22 bits; atol 1e-3 in the
clamp case, whose partial sums reach the hundreds). bfloat16 atol 0.05 +
rtol 0.02: the kernels keep f32 where the plain path rounds after each of
its ~6 ops (bf16 keeps 8 bits).
"""

import numpy as np
import pytest
import torch

from migan_tpu_torch.models.migan_inference import GeneratorConfig
from migan_tpu_torch.models.migan_kernels import kernel_shapes
from migan_tpu_torch.ops.kernels import (
    downblock, fused_block, fused_down_block, fused_up_block, plan, sepconv,
    upblock,
)

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 2e-2)}
# the kernel launches of one migan-512 forward, deduplicated
MAIN_SHAPES = sorted(set(kernel_shapes(GeneratorConfig(resolution=512))),
                     key=str)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _r(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)


def _sep(rng, c, o):
    """[3,3,C], [C], [C,O] weights."""
    return _r(rng, 3, 3, c, scale=0.3), _r(rng, c), _r(rng, c, o,
                                                       scale=c ** -0.5)


def _on(dev, *ts, dtype=torch.float32):
    return [t.to(dev, dtype) for t in ts]


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _up(rng, n, hl, wl, c, o):
    """upblock's inputs: x_lo, skip, noise_up, dw/pw weights, noise2,
    w_rgb, b_rgb. w_rgb is scaled by O^-1/2, as the model's torgb weights
    are, so that rgb keeps the same size at every O."""
    hh, wh = 2 * hl, 2 * wl
    return (_r(rng, n, hl, wl, c), _r(rng, n, hh, wh, c),
            _r(rng, hh, wh, scale=0.1), *_sep(rng, c, o),
            _r(rng, hh, wh, scale=0.1), _r(rng, o, 3, scale=o ** -0.5),
            _r(rng, 3, scale=0.1))


def _held(dev, kernel, args, dtype, **kw):
    """Launch `kernel` once, check that it counted one launch, and hold
    each of its outputs against its plain version."""
    mod, fused, plain = {
        "sepconv": (sepconv, fused_block, sepconv.sepconv_plain),
        "downblock": (downblock, fused_down_block,
                      downblock.downblock_plain),
        "upblock": (upblock, fused_up_block, upblock.upblock_plain)}[kernel]
    before = mod.COUNTER.count
    got = fused(*args, **kw)
    torch.cuda.synchronize()
    assert mod.COUNTER.count == before + 1
    want = plain(*args, **kw)
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, dtype)
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("final_act", [True, False])
def test_sepconv_matches_plain(dev, final_act):
    rng = np.random.RandomState(5)
    args = _on(dev, _r(rng, 2, 24, 40, 96), *_sep(rng, 96, 160),
               _r(rng, 24, 40, scale=0.1))
    before = sepconv.COUNTER.count
    got = fused_block(*args, final_act=final_act)
    torch.cuda.synchronize()
    assert sepconv.COUNTER.count == before + 1
    want = sepconv.sepconv_plain(*args, final_act=final_act)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_sepconv_clamp_matches_plain(dev):
    rng = np.random.RandomState(8)
    args = _on(dev, _r(rng, 2, 16, 16, 64, scale=400.0), *_sep(rng, 64, 64))
    want = sepconv.sepconv_plain(*args)
    assert (want.abs() == 256).float().mean() > 0.05
    torch.testing.assert_close(fused_block(*args), want, rtol=1e-4,
                               atol=1e-3)


def test_downblock_matches_plain(dev):
    rng = np.random.RandomState(6)
    args = _on(dev, _r(rng, 2, 24, 40, 96), *_sep(rng, 96, 160))
    before = downblock.COUNTER.count
    got = fused_down_block(*args)
    torch.cuda.synchronize()
    assert downblock.COUNTER.count == before + 1
    torch.testing.assert_close(got, downblock.downblock_plain(*args),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("emit_features", [True, False])
def test_upblock_matches_plain(dev, emit_features):
    rng = np.random.RandomState(7)
    n, hl, wl, c, o = 2, 12, 20, 96, 160
    args = _on(dev, _r(rng, n, hl, wl, c), _r(rng, n, 2 * hl, 2 * wl, c),
               _r(rng, 2 * hl, 2 * wl, scale=0.1), *_sep(rng, c, o),
               _r(rng, 2 * hl, 2 * wl, scale=0.1), _r(rng, o, 3, scale=0.2),
               _r(rng, 3, scale=0.1))
    before = upblock.COUNTER.count
    got = fused_up_block(*args, emit_features=emit_features)
    torch.cuda.synchronize()
    assert upblock.COUNTER.count == before + 1
    want = upblock.upblock_plain(*args, emit_features=emit_features)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    rng = np.random.RandomState(9)
    x, *w = _on(dev, _r(rng, 1, 8, 8, 32), *_sep(rng, 32, 32))
    with pytest.raises(TypeError):
        fused_block(x.double(), *(t.double() for t in w))
    with pytest.raises(ValueError, match="contiguous"):
        fused_block(x.permute(0, 2, 1, 3), *w)
    with pytest.raises(ValueError, match="shapes"):
        fused_block(x, w[0], w[1], w[2][:16])
    with pytest.raises(ValueError, match="even"):
        fused_down_block(x[:, :7].contiguous(), *w)


@pytest.mark.parametrize("kernel", ["sepconv", "downblock", "upblock"])
def test_channels_stream_in_chunks_at_1024(dev, kernel):
    """Every kernel streams C through shared memory in chunks, so C = 1024
    runs and matches the plain version."""
    rng = np.random.RandomState(11)
    if kernel == "upblock":
        args = _on(dev, *_up(rng, 1, 4, 6, 1024, 64))
    else:
        args = _on(dev, _r(rng, 1, 8, 12, 1024), *_sep(rng, 1024, 64))
    _held(dev, kernel, args, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,hl,wl,c,o", [
    (1, 16, 16, 512, 512),   # several output tiles: partial sums + sum pass
    (2, 20, 12, 64, 64),     # one output tile: rgb written by the block
])
def test_upblock_rgb_is_the_same_from_run_to_run(dev, n, hl, wl, c, o,
                                                 dtype):
    """torgb sums in a fixed order, with no float atomics: two launches
    give bit-identical rgb (and features)."""
    rng = np.random.RandomState(13)
    args = _on(dev, *_up(rng, n, hl, wl, c, o), dtype=dtype)
    f1, rgb1 = fused_up_block(*args)
    f2, rgb2 = fused_up_block(*args)
    torch.cuda.synchronize()
    assert torch.equal(rgb1, rgb2) and torch.equal(f1, f2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MAIN_SHAPES,
                         ids=lambda s: "{}-{}x{}-{}to{}-{}".format(*s))
def test_main_path_shapes_match_plain(dev, shape, dtype):
    """Every kernel shape of a migan-512 forward, N = 1 (upblock with
    both outputs)."""
    kernel, h, w, c, o, final_act = shape
    rng = np.random.RandomState(h + c + o)
    if kernel == "upblock":
        args = _on(dev, *_up(rng, 1, h, w, c, o), dtype=dtype)
    else:
        args = _on(dev, _r(rng, 1, h, w, c), *_sep(rng, c, o), dtype=dtype)
    kw = {} if final_act is None else {"final_act": final_act}
    _held(dev, kernel, args, dtype, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,c,o", [
    (1, 26, 42, 128, 64),    # O below the large tiles' 128
    (3, 18, 10, 96, 160),    # C and O not multiples of the tiles
    (2, 6, 14, 40, 24),      # one ragged K chunk, O below every tile
])
def test_ragged_tiles_match_plain(dev, n, h, w, c, o, dtype):
    """Odd H and W (ragged pixel tiles), C and O that are not multiples of
    the tiles, for every kernel, with noise for sepconv; upblock with x_lo
    [n, h, w, c], so its hi-res 2h x 2w is no multiple of its tiles."""
    rng = np.random.RandomState(c + o)
    x, *wts = _on(dev, _r(rng, n, h, w, c), *_sep(rng, c, o), dtype=dtype)
    noise = _on(dev, _r(rng, h, w, scale=0.1), dtype=dtype)[0]
    for fa in (True, False):
        _held(dev, "sepconv", (x, *wts, noise), dtype, final_act=fa)
    _held(dev, "downblock", (x, *wts), dtype)
    up = _on(dev, *_up(rng, n, h, w, c, o), dtype=dtype)
    for emit in (True, False):
        _held(dev, "upblock", up, dtype, emit_features=emit)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,hl,wl,c,o,cfg", [
    (3, 35, 29, 64, 128, 0),   # 8 x 8 tiles, one output tile
    (3, 27, 21, 96, 128, 1),   # 8 x 8 tiles, two output tiles, ragged K
    (2, 7, 5, 40, 200, 2),     # 4 x 4 tiles, O not a multiple of 64
])
def test_upblock_ragged_tiles_match_plain(dev, n, hl, wl, c, o, cfg, dtype):
    """The hi-res image (2 hl x 2 wl) is no multiple of the tile of each
    upblock configuration, so every configuration runs partial tiles at
    the bottom and right edges, with both outputs and with rgb only."""
    assert plan.launch_plan("upblock", n, hl, wl, o, dtype).config == cfg
    rng = np.random.RandomState(c + o + cfg)
    args = _on(dev, *_up(rng, n, hl, wl, c, o), dtype=dtype)
    for emit in (True, False):
        _held(dev, "upblock", args, dtype, emit_features=emit)


def test_wrappers_refuse_widths_the_kernels_do_not_take(dev):
    """O must be a multiple of 8 (the weights arrive as 16-byte vectors):
    the wrapper raises before it launches, counting nothing."""
    rng = np.random.RandomState(12)
    args = _on(dev, _r(rng, 1, 8, 8, 32), *_sep(rng, 32, 36))
    before = (sepconv.COUNTER.count, downblock.COUNTER.count)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_block(*args)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_down_block(*args)
    assert (sepconv.COUNTER.count, downblock.COUNTER.count) == before


# ---------------------------------------------------------------------------
# The serve and evaluate entry points on the card
# ---------------------------------------------------------------------------

def _weights(tmp_path, res):
    from migan_tpu_torch.cli.trace import seeded_generator
    from migan_tpu_torch.io import save_npz

    path = str(tmp_path / f"migan{res}.npz")
    save_npz(path, seeded_generator(res, res))
    return path


def _u8(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
               .max())


def test_pipeline_stages_on_card_match_cpu(dev):
    """The app pipeline's pre and post on the card against the CPU: the
    same box, the generator input within 1e-5 but for one uint8 step at
    .5 rounding ties, the composite within 1 uint8."""
    from migan_tpu_torch.export.pipeline import make_pipeline_stages

    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (1, 700, 900, 3)).astype(np.uint8)
    mask = np.full((1, 700, 900, 1), 255, np.uint8)
    mask[0, 200:420, 300:520] = 0
    out = rng.uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32)
    results = []
    for device in ("cpu", "cuda"):
        pre, post = make_pipeline_stages(512, device=device)
        x, box = pre(img, mask)
        results.append((x.cpu(), box.cpu(),
                        post(img, mask, out, box).cpu()))
    (x0, b0, y0), (x1, b1, y1) = results
    assert torch.equal(b0, b1)
    err = (x0 - x1).abs()
    assert float(err.max()) <= 2 / 255 + 1e-6
    assert int((err > 1e-5).sum()) <= 0.01 * err.numel()
    assert _u8(y0.numpy(), y1.numpy()) <= 1


def test_detectors_on_card_match_cpu(dev):
    """Inception (512 input: the antialiased resize) and LPIPS in float32
    on the card against the CPU, rtol 1e-3 / atol 1e-4 and per-image LPIPS
    atol 1e-5: the same sums in another order."""
    from migan_tpu_torch.evalx import inception, lpips

    inc = inception.import_inception_state_dict(
        {k: v.numpy() for k, v in inception.seeded_state_dict(0).items()})
    lp = lpips.import_lpips_state_dict(lpips.seeded_state_dict(1))
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.rand(2, 512, 512, 3).astype(np.float32))
    b = (a + 0.1 * torch.from_numpy(rng.randn(*a.shape).astype(
        np.float32))).clamp(0, 1)
    want = inception.inception_apply(inc, a)
    got = inception.inception_apply(inc.to(dev), a.to(dev)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
    want = lp(a, b)
    got = lp.to(dev)(a.to(dev), b.to(dev)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_load_model_keeps_float32_out_of_tf32(dev, tmp_path):
    """`load_model` on the card turns TF32 off for cuDNN and matmuls, so
    the float32 convs below the kernel levels and the detectors of the
    serve and evaluate CLIs run in IEEE float32, as the kernels do."""
    from migan_tpu_torch.cli.demo import load_model

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    load_model("migan-256", _weights(tmp_path, 256), "float32", "cuda")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_served_replies_match_direct_program(dev, tmp_path):
    """migan-256 behind the port's server on the card: 6 concurrent
    requests, batched, each reply within 1 uint8 of the direct program
    at N = 1, and 15 kernel launches per dispatch."""
    import base64
    import io
    import json
    import threading
    import urllib.request

    from PIL import Image

    from migan_tpu_torch.cli import serve
    from migan_tpu_torch.cli.demo import load_model
    from migan_tpu_torch.data.preprocess import postprocess
    from migan_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    fwd, res = load_model("migan-256", _weights(tmp_path, 256), "float32",
                          "cuda")
    srv, batcher = serve.make_server(fwd, res, "127.0.0.1", 0, "migan-256",
                                     max_batch=4, window_ms=50.0)
    batcher.warmup()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    rng = np.random.RandomState(5)
    bodies = []
    for i in range(6):
        img = rng.randint(0, 256, (200 + 20 * i, 300, 3)).astype(np.uint8)
        mask = np.full(img.shape[:2], 255, np.uint8)
        mask[40:120, 50:200] = 0
        enc = []
        for arr in (img, mask):
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG")
            enc.append(base64.b64encode(buf.getvalue()).decode())
        bodies.append(json.dumps({"image": enc[0], "mask": enc[1]}).encode())
    replies = [None] * len(bodies)

    def client(i):
        req = urllib.request.Request(f"http://127.0.0.1:"
                                     f"{srv.server_address[1]}/inpaint",
                                     data=bodies[i])
        with urllib.request.urlopen(req, timeout=120) as resp:
            replies[i] = np.asarray(Image.open(io.BytesIO(resp.read())))

    n0 = len(batcher.batch_sizes_served)
    reset_launch_counts()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        counts = launch_counts()
        served = batcher.batch_sizes_served[n0:]
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
    assert sum(served) == len(bodies) and max(served) > 1, served
    assert counts == {"sepconv": 7 * len(served),
                      "downblock": 4 * len(served),
                      "upblock": 4 * len(served)}
    for body, got in zip(bodies, replies):
        x, img_r, mask_r = serve._decode_request(body, res)
        want = postprocess(fwd(x).cpu().numpy()[0], img_r, mask_r)
        assert _u8(got, want) <= 1


def test_evaluate_on_card_matches_cpu(dev, tmp_path):
    """The evaluation CLI on the card and on the CPU, migan-256, 4 seeded
    images: per-image LPIPS within 1e-4 and the Inception activations
    within 1e-3 relative L2 (the kernel chain is within ~1e-5 of the
    plain generator)."""
    from PIL import Image

    from migan_tpu_torch.cli import evaluate
    from migan_tpu_torch.evalx import inception, lpips

    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.RandomState(6)
    for i in range(4):
        Image.fromarray(rng.randint(0, 256, (256, 256, 3)).astype(
            np.uint8)).save(images / f"{i}.png")
    torch.save(inception.seeded_state_dict(0), tmp_path / "inc.pth")
    torch.save(lpips.seeded_state_dict(1), tmp_path / "lp.pth")
    argv = ["--model-name", "migan-256", "--model-path",
            _weights(tmp_path, 256), "--real-dir", str(images),
            "--inception-weights", str(tmp_path / "inc.pth"),
            "--lpips-weights", str(tmp_path / "lp.pth"),
            "--batch-size", "4"]
    runs = []
    for device in ("cuda", "cpu"):
        details = {}
        evaluate.main(argv + ["--device", device], details=details)
        runs.append(details)
    card, cpu = runs
    assert np.abs(card["lpips"] - cpu["lpips"]).max() <= 1e-4
    for k in ("real_acts", "fake_acts"):
        rel = (np.linalg.norm(card[k] - cpu[k], axis=1)
               / np.linalg.norm(cpu[k], axis=1))
        assert rel.max() <= 1e-3, (k, rel)
