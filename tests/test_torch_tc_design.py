"""The tensor-core design of the sepconv, downblock and upblock kernels,
checked on the CPU: the launch geometry of `ops/kernels/plan.py` at every
main-path shape, a numeric model of the float32 route (three TF32
products), a model of upblock's tiled algorithm, the kernels' weight
layout, and the shape list that chip_smoke and the card tests time and
hold the kernels at.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from migan_tpu_torch.cli.trace import seeded_generator, seeded_input
from migan_tpu_torch.io import save_npz
from migan_tpu_torch.models import migan_kernels
from migan_tpu_torch.models.migan_inference import GeneratorConfig
from migan_tpu_torch.models.migan_kernels import (
    KernelGenerator, kernel_shapes,
)
from migan_tpu_torch.ops.kernels import downblock, sepconv, upblock
from migan_tpu_torch.ops.kernels.plan import (
    CONFIGS, KC, MAX_SMEM_BYTES, NUM_SMS, check_tc_args, launch_plan,
    pixel_tiles, smem_bytes,
)
from migan_tpu_torch.ops.kernels.sepconv import ACT

DTYPES = [torch.float32, torch.bfloat16]

# The main-path shapes of migan-512 (H = W, C -> O), as the kernels' design
# was sized for them; kernel_shapes must give exactly these.
MIGAN512 = {
    ("sepconv", True): {(512, 64, 64), (256, 128, 128), (128, 256, 256),
                        (64, 512, 512), (32, 512, 512)},
    ("sepconv", False): {(256, 128, 64), (128, 256, 128), (64, 512, 256),
                         (32, 512, 512)},
    ("downblock", None): {(512, 64, 128), (256, 128, 256), (128, 256, 512),
                          (64, 512, 512), (32, 512, 512)},
    # x_lo's H
    ("upblock", None): {(256, 64, 64), (128, 128, 128), (64, 256, 256),
                        (32, 512, 512), (16, 512, 512)},
}


def _tc_shapes(res):
    return kernel_shapes(GeneratorConfig(resolution=res))


def test_kernel_shapes_are_the_main_path_shapes():
    got = {}
    for kernel, h, w, c, o, final_act in _tc_shapes(512):
        assert h == w
        got.setdefault((kernel, final_act), set()).add((h, c, o))
    assert got == MIGAN512
    counts = {}
    for res, want in ((512, (9, 5, 5)), (256, (7, 4, 4))):
        for s in kernel_shapes(GeneratorConfig(resolution=res)):
            counts[res, s[0]] = counts.get((res, s[0]), 0) + 1
        assert tuple(counts[res, k] for k in
                     ("sepconv", "downblock", "upblock")) == want


def test_kernel_shapes_follow_the_kernel_chain(monkeypatch):
    """KernelGenerator launches the kernels at kernel_shapes' shapes, in
    that order (migan-64 on the CPU, where the wrappers run their plain
    versions)."""
    calls = []

    def spy(name, fn, shape_of):
        def wrapped(*args, **kw):
            calls.append((name, *shape_of(*args, **kw)))
            return fn(*args, **kw)
        return wrapped

    def sep_shape(x, w_dw, b_dw, w_pw, noise=None, final_act=True):
        return (*x.shape[1:], w_pw.shape[1], final_act)

    def other_shape(x, w_dw_or_skip, *rest, **kw):
        return (*x.shape[1:], None, None)

    monkeypatch.setattr(migan_kernels, "fused_block",
                        spy("sepconv", sepconv.fused_block, sep_shape))
    monkeypatch.setattr(migan_kernels, "fused_down_block",
                        spy("downblock", downblock.fused_down_block,
                            other_shape))
    monkeypatch.setattr(migan_kernels, "fused_up_block",
                        spy("upblock", upblock.fused_up_block, other_shape))
    cfg = GeneratorConfig(resolution=64)
    KernelGenerator(seeded_generator(64, 3))(seeded_input(1, 64, 4))
    want = [(k, h, w, c, o if k == "sepconv" else None, fa)
            for k, h, w, c, o, fa in kernel_shapes(cfg)]
    assert calls == want


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("res", [512, 256])
def test_launch_plan_fills_the_card(res, n, dtype):
    """At every main-path shape a launch has at least one block per SM of
    an H100 and fits a block's shared memory, with the configuration's
    thread count; its blocks cover every output pixel and channel."""
    for kernel, h, w, c, o, _ in _tc_shapes(res):
        p = launch_plan(kernel, n, h, w, o, dtype)
        cfg = CONFIGS[kernel][p.config]
        assert p.blocks >= NUM_SMS, (kernel, n, h, c, o, p)
        assert p.smem_bytes <= MAX_SMEM_BYTES, (kernel, h, c, o, p)
        assert p.threads == cfg.threads
        assert p.out_tiles == -(-o // cfg.to)
        assert p.blocks == pixel_tiles(kernel, n, h, w, cfg) * p.out_tiles
        out_pixels = {"sepconv": n * h * w, "downblock": n * h * w // 4,
                      "upblock": n * h * w * 4}[kernel]
        assert p.blocks * cfg.tp * cfg.to >= out_pixels * o


@pytest.mark.parametrize("kernel", ["sepconv", "downblock", "upblock"])
def test_every_configuration_fits_a_block(kernel):
    """C is streamed, so a configuration's shared memory is fixed: each
    fits a block in both dtypes, and the largest tiles leave room for at
    least one block (downblock) or two (sepconv, upblock) per SM."""
    for dtype in DTYPES:
        sizes = [smem_bytes(kernel, cfg, dtype) for cfg in CONFIGS[kernel]]
        assert max(sizes) <= MAX_SMEM_BYTES
        per_sm = 1 if kernel == "downblock" else 2
        assert per_sm * (sizes[0] + 1024) <= 233_472   # 228 KB per SM


def test_launch_plan_small_and_unknown():
    # too few pixels for a full wave: the smallest tile, whatever O
    p = launch_plan("sepconv", 1, 4, 4, 40, torch.float32)
    assert p.config == len(CONFIGS["sepconv"]) - 1 and p.blocks == 2
    with pytest.raises(ValueError, match="unknown kernel"):
        launch_plan("no_such_kernel", 1, 8, 8, 64, torch.float32)


@pytest.mark.parametrize("c,o,match", [(36, 64, "multiples of 8"),
                                       (64, 36, "multiples of 8")])
def test_check_tc_args_refuses_widths(c, o, match):
    x, w_pw = torch.zeros(1, 4, 4, c), torch.zeros(c, o)
    with pytest.raises(ValueError, match=match):
        check_tc_args("fused_block", x, w_pw)
    check_tc_args("fused_block", torch.zeros(1, 4, 4, 64),
                  torch.zeros(64, 64))


def test_check_tc_args_refuses_misaligned_weights():
    w_pw = torch.zeros(64 * 64 + 1)[1:].view(64, 64)   # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        check_tc_args("fused_block", torch.zeros(1, 4, 4, 64), w_pw)


def _tf32(a: np.ndarray) -> np.ndarray:
    """float32 -> TF32 as `cvt.rna.tf32.f32` rounds: to nearest, ties away
    from zero, at 10 mantissa bits (the low 13 bits zero)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm(a, b):
    """float32 product on the CPU: products of TF32 values are exact in
    float32, and the sums are float32, as in the tensor cores."""
    return (torch.from_numpy(a) @ torch.from_numpy(b)).numpy()


def test_three_tf32_products_hold_the_float32_tolerance():
    """The float32 route of the kernels: a [64, 512] x [512, 512] product
    (a C = 512 pixel tile) as a_lo b_hi + a_hi b_lo + a_hi b_hi on TF32
    splits stays within atol/rtol 1e-4 of the float64 product, the hold of
    the kernels against their plain versions. One TF32 product does not,
    which is why the split exists."""
    rng = np.random.RandomState(0)
    a = (np.abs(rng.randn(64, 512)) * 1.5).astype(np.float32)  # act >= 0
    a[:, ::2] *= -0.2                                           # lrelu side
    b = (rng.randn(512, 512) / np.sqrt(512)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    three = _mm(a_lo, b_hi) + _mm(a_hi, b_lo) + _mm(a_hi, b_hi)
    one = _mm(a_hi, b_hi)
    limit = 1e-4 + 1e-4 * np.abs(exact)
    assert (np.abs(three - exact) <= limit).all()
    assert np.abs(three - exact).max() < 1e-5
    assert (np.abs(one - exact) > limit).sum() > 100


def test_tf32_rounding_model():
    x = np.array([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0],
                 np.float32)
    # ties round away from zero; 11 significant bits are kept
    np.testing.assert_array_equal(
        _tf32(x), np.array([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0],
                           np.float32))


def test_kernel_weights_round_trip_to_the_jax_layout(tmp_path):
    """The kernels take the JAX package's layout, made once by
    `SepWeights.of`: w_dw [3, 3, C] (HWIO without I), b_dw [C], w_pw
    [C, O] (HWIO without H, W), contiguous and 16-byte aligned (the
    kernels copy w_pw as 16-byte vectors). They equal the arrays of the
    `.npz` the JAX package reads."""
    g = seeded_generator(64, 5)
    path = tmp_path / "w.npz"
    save_npz(str(path), g)
    chain = KernelGenerator(g)
    npz = np.load(path)
    checked = 0
    for part, levels in (("encoder", chain.enc), ("synthesis", chain.syn)):
        for r, ws in levels.items():
            for name, w in zip(("conv1", "conv2"), ws[:2]):
                key = f"{part}/b{r}/{name}"
                dw = npz[f"{key}/conv1/weight"]      # [3, 3, 1, C]
                pw = npz[f"{key}/conv2/weight"]      # [1, 1, C, O]
                np.testing.assert_array_equal(w.w_dw.detach().numpy(),
                                              dw[:, :, 0])
                np.testing.assert_array_equal(
                    w.b_dw.detach().numpy(), npz[f"{key}/conv1/bias"])
                np.testing.assert_array_equal(w.w_pw.detach().numpy(),
                                              pw[0, 0])
                for t in (w.w_dw, w.b_dw, w.w_pw):
                    assert t.is_contiguous() and t.data_ptr() % 16 == 0
                checked += 1
    assert checked == 8


def _window(a, r0, nr, c0, nc):
    """a[:, r0 : r0 + nr, c0 : c0 + nc] of an [N, H, W, C] tensor, with
    zeros where the window leaves the image (as cp.async zero-fills)."""
    n, h, w, c = a.shape
    out = a.new_zeros(n, nr, nc, c)
    rs, re = max(r0, 0), min(r0 + nr, h)
    cs, ce = max(c0, 0), min(c0 + nc, w)
    if rs < re and cs < ce:
        out[:, rs - r0:re - r0, cs - c0:ce - c0] = a[:, rs:re, cs:ce]
    return out


def _interleave(a, b, dim):
    """a[0], b[0], a[1], b[1], ... along dim."""
    return torch.stack([a, b], dim=dim + 1).flatten(dim, dim + 1)


def _tiled_upblock(x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2, w_rgb,
                   b_rgb, th, tw, to):
    """upblock as csrc/upblock.cu computes it: per th x tw tile of hi-res
    pixels, the x_lo window (th/2 + 2) x (tw/2 + 2) and the skip window
    (th + 2) x (tw + 2), zero outside the image; t over the window from
    the separable 0.75 / 0.25 taps (along w, then h) and zero outside the
    image; per K chunk of KC channels the dw 3x3 and the product with
    that chunk's weight rows; per output tile of `to` channels the rgb
    partial sums, added in tile order."""
    n, hl, wl, c = x_lo.shape
    hh, wh, o = 2 * hl, 2 * wl, w_pw.shape[1]
    n_ot = -(-o // to)
    w_pw = torch.nn.functional.pad(w_pw, (0, n_ot * to - o))
    w_rgb = torch.nn.functional.pad(w_rgb, (0, 0, 0, n_ot * to - o))
    feat = x_lo.new_zeros(n, hh, wh, o)
    part = x_lo.new_zeros(n_ot, n, hh, wh, 3)
    ones = x_lo.new_ones(1, hh, wh, 1)
    for h0 in range(0, hh, th):
        for w0 in range(0, wh, tw):
            xw = _window(x_lo, h0 // 2 - 1, th // 2 + 2, w0 // 2 - 1,
                         tw // 2 + 2)
            win = (h0 - 1, th + 2, w0 - 1, tw + 2)
            # window column 2j is hi-res column w0 - 1 + 2j (odd):
            # .75 x[j] + .25 x[j + 1]; column 2j + 1: .75 x[j + 1] + .25 x[j]
            u = _interleave(.75 * xw[:, :, :-1] + .25 * xw[:, :, 1:],
                            .75 * xw[:, :, 1:] + .25 * xw[:, :, :-1], 2)
            up = _interleave(.75 * u[:, :-1] + .25 * u[:, 1:],
                             .75 * u[:, 1:] + .25 * u[:, :-1], 1)
            t = ((ACT(up + _window(noise_up[None, :, :, None], *win))
                  + _window(skip, *win)) * _window(ones, *win))
            acc = x_lo.new_zeros(n, th, tw, n_ot * to)
            for k0 in range(0, c, KC):
                k1 = min(k0 + KC, c)
                dw = sum(t[:, dy:dy + th, dx:dx + tw, k0:k1]
                         * w_dw[dy, dx, k0:k1]
                         for dy in range(3) for dx in range(3))
                acc += ACT(dw + b_dw[k0:k1]) @ w_pw[k0:k1]
            y = ACT(acc + _window(noise2[None, :, :, None], h0, th, w0, tw))
            hi, wi = min(th, hh - h0), min(tw, wh - w0)
            feat[:, h0:h0 + hi, w0:w0 + wi] = y[:, :hi, :wi, :o]
            for ot in range(n_ot):
                cols = slice(ot * to, (ot + 1) * to)
                part[ot, :, h0:h0 + hi, w0:w0 + wi] = (
                    y[:, :hi, :wi, cols] @ w_rgb[cols])
    rgb = part[0]
    for ot in range(1, n_ot):
        rgb = rgb + part[ot]
    return feat, rgb + b_rgb


@pytest.mark.parametrize("cfg", range(3))
@pytest.mark.parametrize("n,hl,wl,c,o", [
    (2, 5, 7, 40, 24),       # ragged tiles both ways, one ragged K chunk
    (3, 9, 6, 72, 136),      # O over several output tiles, ragged
    (1, 4, 12, 64, 64),      # whole tiles of 8 x 8
])
def test_upblock_tiled_model_matches_plain(n, hl, wl, c, o, cfg):
    """The index arithmetic of csrc/upblock.cu, which no CPU run of the
    kernel can reach: its tiled algorithm, modelled in PyTorch with each
    upblock tile configuration of plan.py, gives upblock_plain's features
    and rgb in float32 at 1e-5."""
    tile = CONFIGS["upblock"][cfg]
    rng = np.random.RandomState(n + hl + c + cfg)

    def r(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)

    args = (r(n, hl, wl, c), r(n, 2 * hl, 2 * wl, c),
            r(2 * hl, 2 * wl, scale=.3), r(3, 3, c, scale=.3), r(c),
            r(c, o, scale=c ** -.5), r(2 * hl, 2 * wl, scale=.3),
            r(o, 3, scale=o ** -.5), r(3, scale=.1))
    got = _tiled_upblock(*args, tile.th, tile.tp // tile.th, tile.to)
    want = upblock.upblock_plain(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
