"""Each CUDA kernel of `migan_tpu_torch` against its plain PyTorch version on
the card: float32 with TF32 off at odd sizes that leave ragged tiles, and
every kernel at every main-path shape of migan-512 in float32 and
bfloat16.

Marked `cuda`: skips where no CUDA device is present. This file imports
no JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

The fused training call (`train_step.FusedTrainStep`) on the card: its
CUDA-graph replays under deterministic algorithms are bit-equal to the
sequential steps (tolerance: none), and a step that cannot be captured
raises.

Tolerances: float32 rtol/atol 1e-4, the same float32 sums in another order
(the kernels' three-pass TF32 product keeps ~22 bits; atol 1e-3 in the
clamp case, whose partial sums reach the hundreds). bfloat16 atol 0.05 +
rtol 0.02: the kernels keep f32 where the plain path rounds after each of
its ~6 ops (bf16 keeps 8 bits).

The kernels' options (fused_block's skip and pointwise prologue,
fused_up_block's phase input) at the JAX tests' shapes, migan-512's and
ragged ones, with the same tolerances; in bfloat16 against the plain
version in float32 on the same inputs (`_held_option`), and the border
rows of the prologue's zero padding.

fused_up_block's rgb fold (`img_lo`) at every upblock shape of migan-512
and migan-256, with one output tile and several, against the plain
composition (the kernel's rgb plus `upsample2d` of the image; float32
atol/rtol 1e-6, the rounding of the FIR's sum) and against the plain
version; its counter over a forward.
"""

import os

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from migan_tpu_torch.models.migan_inference import GeneratorConfig
from migan_tpu_torch.models.migan_kernels import kernel_shapes
from migan_tpu_torch.ops.kernels import (
    direct_launch_counts, downblock, fused_block, fused_down_block,
    fused_up_block, launch, launch_counts, plan, reset_launch_counts,
    rgb_fold_count, sepconv, upblock,
)

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 2e-2)}
BF16_FACTOR = 2.0
# the kernel launches of one migan-512 forward, deduplicated
MAIN_SHAPES = sorted(set(kernel_shapes(GeneratorConfig(resolution=512))),
                     key=str)

pytestmark = pytest.mark.cuda
# cuBLAS's deterministic workspace (the fused-step tests run with
# deterministic algorithms), read when cuBLAS is first used
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


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


def _launches(mod) -> int:
    """Launches counted for the kernel of module `mod`."""
    return launch_counts()[mod.__name__.rsplit(".", 1)[1]]


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
    before = _launches(mod)
    got = fused(*args, **kw)
    torch.cuda.synchronize()
    assert _launches(mod) == before + 1
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
    before = _launches(sepconv)
    got = fused_block(*args, final_act=final_act)
    torch.cuda.synchronize()
    assert _launches(sepconv) == before + 1
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
    before = _launches(downblock)
    got = fused_down_block(*args)
    torch.cuda.synchronize()
    assert _launches(downblock) == before + 1
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
    before = _launches(upblock)
    got = fused_up_block(*args, emit_features=emit_features)
    torch.cuda.synchronize()
    assert _launches(upblock) == before + 1
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
@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("shape", MAIN_SHAPES,
                         ids=lambda s: "{}-{}x{}-{}to{}-{}".format(*s))
def test_main_path_shapes_match_plain(dev, shape, n, dtype):
    """Every kernel shape of a migan-512 forward, from the top level down
    to the 4x4 one, at N = 1 and 16 (upblock with both outputs). In
    bfloat16 at N = 16, up to 2.7e8 elements, held as `_held_option`
    holds the options: at that count a few elements of the plain bfloat16
    version itself fall outside the tolerance of the float32 result."""
    kernel, h, w, c, o, final_act = shape
    rng = np.random.RandomState(h + c + o + n)
    if kernel == "upblock":
        args = _on(dev, *_up(rng, n, h, w, c, o), dtype=dtype)
    else:
        args = _on(dev, _r(rng, n, h, w, c), *_sep(rng, c, o), dtype=dtype)
    kw = {} if final_act is None else {"final_act": final_act}
    held = _held_option if n > 1 else _held
    held(dev, kernel, args, dtype, **kw)


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


# ---------------------------------------------------------------------------
# fused_up_block's rgb fold (img_lo): the rgb pyramid's up-2 FIR and add
# ---------------------------------------------------------------------------

# every upblock launch of a migan-512 and a migan-256 forward, (Hl, Wl, C,
# O, emit_features): the top level stores no features
def _fold_shapes():
    shapes = set()
    for res in (256, 512):
        ups = [s for s in kernel_shapes(GeneratorConfig(resolution=res))
               if s[0] == "upblock"]
        top = max(s[1] for s in ups)
        shapes |= {(h, w, c, o, h != top) for _, h, w, c, o, _ in ups}
    return sorted(shapes)


FOLD_SHAPES = _fold_shapes()
# (n, Hl, Wl, C, O): ragged, non-square, one output tile and more
FOLD_RAGGED = [(3, 35, 29, 64, 128), (3, 27, 21, 96, 128),
               (2, 7, 5, 40, 200)]
FOLD_TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: TOL[torch.bfloat16]}


def _held_fold(dev, args, dtype, emit):
    """The fold against the plain composition on the card: the kernel's
    own rgb without img_lo, plus `upsample2d` of img_lo (in float32 they
    differ by the rounding of the FIR's sum alone; in bfloat16 the
    composition rounds once more). The features equal those of the launch
    without img_lo, bit for bit, and one launch counts one fold."""
    from migan_tpu_torch.ops.filters import setup_filter
    from migan_tpu_torch.ops.upfirdn2d import upsample2d

    n, hl, wl = args[0].shape[:3]
    img = _on(dev, _r(np.random.RandomState(hl + wl), n, hl, wl, 3),
              dtype=dtype)[0]
    reset_launch_counts()
    got = _outs(fused_up_block(*args, emit_features=emit, img_lo=img))
    torch.cuda.synchronize()
    assert rgb_fold_count() == launch_counts()["upblock"] == 1
    base = _outs(fused_up_block(*args, emit_features=emit))
    assert rgb_fold_count() == 1 and launch_counts()["upblock"] == 2
    up = upsample2d(img.float(), setup_filter([1, 3, 3, 1], device=dev))
    want = (up + base[-1].float()).to(dtype)
    atol, rtol = FOLD_TOL[dtype]
    torch.testing.assert_close(got[-1].float(), want.float(), rtol=rtol,
                               atol=atol)
    assert len(got) == len(base) == (2 if emit else 1)
    if emit:
        assert torch.equal(got[0], base[0])
    held = _held_option if n > 1 else _held
    held(dev, "upblock", args, dtype, emit_features=emit, img_lo=img)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("shape", FOLD_SHAPES,
                         ids=lambda s: "{}x{}-{}to{}-{}".format(*s))
def test_upblock_rgb_fold_at_main_path_shapes(dev, shape, n, dtype):
    """Every upblock shape of a migan-512 and a migan-256 forward, with
    the outputs the main path asks for, with img_lo: one output tile
    (rgb stored by the block) and two to eight (`rgb_sum_kernel`)."""
    hl, wl, c, o, emit = shape
    rng = np.random.RandomState(hl + c + n)
    args = _on(dev, *_up(rng, n, hl, wl, c, o), dtype=dtype)
    _held_fold(dev, args, dtype, emit)


def test_fold_shapes_cover_both_rgb_stores():
    """FOLD_SHAPES and FOLD_RAGGED hold shapes of one output tile and of
    several, so the block's store and `rgb_sum_kernel` both fold."""
    tiles = {plan.launch_plan("upblock", n, hl, wl, o, torch.float32)
             .out_tiles > 1
             for n in (1, 3) for hl, wl, _, o, _ in FOLD_SHAPES}
    tiles |= {plan.launch_plan("upblock", n, hl, wl, o, torch.float32)
              .out_tiles > 1 for n, hl, wl, _, o in FOLD_RAGGED}
    assert tiles == {False, True}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,hl,wl,c,o", FOLD_RAGGED)
def test_upblock_rgb_fold_at_ragged_shapes(dev, n, hl, wl, c, o, dtype):
    """Partial tiles at the bottom and right edges, Hl != Wl, with both
    outputs and with rgb only."""
    rng = np.random.RandomState(c + o)
    args = _on(dev, *_up(rng, n, hl, wl, c, o), dtype=dtype)
    for emit in (True, False):
        _held_fold(dev, args, dtype, emit)


@pytest.mark.parametrize("res", [256, 512])
def test_every_upblock_launch_of_a_forward_folds(dev, tmp_path, res):
    """An eager forward through `load_model` folds the rgb pyramid at
    every upblock launch (6 of 6 at migan-256, 7 of 7 at migan-512), and
    a launch without img_lo counts no fold."""
    from migan_tpu_torch.cli.demo import load_model

    forward, _ = load_model(f"migan-{res}", _weights(tmp_path, res),
                            device="cuda")
    x = _on(dev, _r(np.random.RandomState(res), 1, res, res, 4))[0]
    reset_launch_counts()
    forward(x)
    torch.cuda.synchronize()
    assert rgb_fold_count() == launch_counts()["upblock"] == \
        {256: 6, 512: 7}[res]
    reset_launch_counts()
    fused_up_block(*_on(dev, *_up(np.random.RandomState(0), 1, 4, 4, 64,
                                  64)))
    torch.cuda.synchronize()
    assert launch_counts()["upblock"] == 1 and rgb_fold_count() == 0


def test_wrappers_refuse_widths_the_kernels_do_not_take(dev):
    """O must be a multiple of 8 (the weights arrive as 16-byte vectors):
    the wrapper raises before it launches, counting nothing."""
    rng = np.random.RandomState(12)
    args = _on(dev, _r(rng, 1, 8, 8, 32), *_sep(rng, 32, 36))
    before = (_launches(sepconv), _launches(downblock))
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_block(*args)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_down_block(*args)
    assert (_launches(sepconv), _launches(downblock)) == before


# ---------------------------------------------------------------------------
# The kernel options: fused_block's skip and pointwise prologue,
# fused_up_block's phase input
# ---------------------------------------------------------------------------

def _options(rng, kind, x, c, b_pre_scale=0.1):
    """fused_block keyword options of `kind` for x [N,H,W,Cin] and a dw
    stage of C channels (CPU tensors)."""
    cin = x.shape[-1]
    kw = {}
    if kind in ("skip", "both"):
        kw["skip"] = _r(rng, *x.shape)
    if kind in ("prologue", "both"):
        kw["w_pre"] = _r(rng, cin, c, scale=cin ** -0.5)
        kw["b_pre"] = _r(rng, c, scale=b_pre_scale)
    return kw


def _on_kw(dev, kw, dtype):
    return {k: v.to(dev, dtype) for k, v in kw.items()}


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


def _held_option(dev, kernel, args, dtype, **kw):
    """`_held` for the options, and for the main-path shapes at N = 16.
    In bfloat16 the reference is the plain version in float32 on the same
    bfloat16 inputs, at the same bf16 tolerance: the options' plain
    compositions round two or three times
    more than the kernels (x + skip; the prologue's conv, bias and act;
    the phase input's noise and act), so against the plain bfloat16
    version a few elements in millions fall outside it, as both drift
    from float32. The kernel's relative L2 distance from that reference
    must also be at most BF16_FACTOR times the plain bfloat16 version's:
    it may not lose more to rounding than the plain path does."""
    if dtype == torch.float32:
        return _held(dev, kernel, args, dtype, **kw)
    mod, fused, plain = {
        "sepconv": (sepconv, fused_block, sepconv.sepconv_plain),
        "downblock": (downblock, fused_down_block,
                      downblock.downblock_plain),
        "upblock": (upblock, fused_up_block, upblock.upblock_plain)}[kernel]
    f32 = lambda a: a.float() if isinstance(a, torch.Tensor) else a
    before = _launches(mod)
    got = fused(*args, **kw)
    torch.cuda.synchronize()
    assert _launches(mod) == before + 1
    want = plain(*map(f32, args), **{k: f32(v) for k, v in kw.items()})
    plain16 = plain(*args, **kw)
    for g, w, p16 in zip(_outs(got), _outs(want), _outs(plain16)):
        _close(g, w, dtype)
        rel = [((t.float() - w).norm() / w.norm()).item() for t in (g, p16)]
        assert rel[0] <= BF16_FACTOR * rel[1], rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,c,o,kind", [
    (2, 32, 32, 128, 128, 64, "skip"),       # the JAX tests' shape
    (2, 32, 32, 128, 128, 64, "prologue"),
    (2, 32, 32, 128, 128, 64, "both"),
    (2, 32, 32, 8, 128, 128, "prologue"),    # the JAX wide-prologue shape
    (1, 512, 512, 4, 64, 64, "prologue"),    # fromrgb into the top conv1
    (1, 512, 512, 64, 64, 64, "skip"),
    (1, 4, 4, 512, 512, 512, "skip"),        # synthesis b4's conv2
    (16, 4, 4, 512, 512, 512, "skip"),
    (3, 18, 10, 4, 40, 24, "both"),          # ragged tiles, K and O
    (2, 6, 14, 16, 40, 24, "prologue"),      # one ragged K chunk
])
def test_sepconv_options_match_plain(dev, n, h, w, cin, c, o, kind, dtype):
    """skip, the prologue and both, with noise, with and without the
    final act, at the JAX tests' shapes, migan-512's top level and ragged
    sizes."""
    rng = np.random.RandomState(cin + c + o + h)
    x = _r(rng, n, h, w, cin)
    kw = _on_kw(dev, _options(rng, kind, x, c), dtype)
    args = _on(dev, x, *_sep(rng, c, o), _r(rng, h, w, scale=0.1),
               dtype=dtype)
    for fa in (True, False):
        _held_option(dev, "sepconv", args, dtype, final_act=fa, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cin", [4, 8])
def test_sepconv_prologue_zero_pads_its_output(dev, cin, dtype):
    """The dw's zero padding applies to the prologue's output: with a
    large b_pre, act(b_pre) is far from 0, so a kernel that ran the
    prologue on zero-padded x would differ at every border row and
    column. The border rows and columns are held apart from the rest."""
    rng = np.random.RandomState(31 + cin)
    n, h, w, c, o = 2, 40, 56, 64, 64
    x = _r(rng, n, h, w, cin)
    kw = _on_kw(dev, _options(rng, "prologue", x, c, b_pre_scale=0.0),
                dtype)
    kw["b_pre"] += 3.0
    args = _on(dev, x, *_sep(rng, c, o), dtype=dtype)
    got = fused_block(*args, **kw)
    # the plain version in float32 on the same inputs (`_held_option`)
    args = [a.float() for a in args]
    kw = {k: v.float() for k, v in kw.items()}
    want = sepconv.sepconv_plain(*args, **kw)
    # act(b_pre) on the padding instead of 0: what the border would be
    z = sepconv.ACT(torch.nn.functional.pad(args[0], (0, 0, 1, 1, 1, 1))
                    @ kw["w_pre"] + kw["b_pre"])
    y = sepconv.conv2d(z, args[1][:, :, None, :], groups=c) + args[2]
    wrong = sepconv.ACT(sepconv.conv2d(sepconv.ACT(y), args[3][None, None]))
    for rows in (np.s_[:, [0, -1]], np.s_[:, :, [0, -1]]):
        assert (wrong[rows] - want[rows]).abs().max() > 0.5
        _close(got[rows], want[rows], dtype)
    _close(got, want, dtype)


def _phase_args(rng, n, hl, wl, c, o):
    """upblock's inputs with a phase input x4 [n, hl, wl, 4c]."""
    _, *rest = _up(rng, n, hl, wl, c, o)
    return (_r(rng, n, hl, wl, 4 * c), *rest)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,hl,wl,c,o", [
    (2, 8, 16, 128, 128),      # the JAX test's shape
    (1, 256, 256, 64, 64),     # migan-512's top synthesis level
    (1, 128, 128, 128, 128),   # and the level below
    (3, 35, 29, 64, 128),      # ragged 8 x 8 tiles
    (3, 27, 21, 96, 128),      # two output tiles, ragged K
    (2, 7, 5, 40, 200),        # 4 x 4 tiles, O not a multiple of 64
])
def test_upblock_phase_input_matches_plain(dev, n, hl, wl, c, o, dtype):
    """fused_up_block(phase_input=True) against upblock_plain with both
    outputs and with rgb only."""
    rng = np.random.RandomState(hl + c + o)
    args = _on(dev, *_phase_args(rng, n, hl, wl, c, o), dtype=dtype)
    for emit in (True, False):
        _held_option(dev, "upblock", args, dtype, emit_features=emit,
                     phase_input=True)
    _held_option(dev, "upblock", args[:7], dtype, phase_input=True)


def test_upblock_phase_input_at_1024(dev):
    """The phase input's shared memory does not grow with C: C = 1024
    (x4 of 4096 channels) runs and matches the plain version."""
    rng = np.random.RandomState(17)
    args = _on(dev, *_phase_args(rng, 1, 4, 6, 1024, 64))
    p = plan.launch_plan("upblock", 1, 4, 6, 64, torch.float32,
                         mode=plan.UP_PHASE)
    assert p.smem_bytes <= plan.MAX_SMEM_BYTES
    _held(dev, "upblock", args, torch.float32, phase_input=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_phase_chain_equals_the_stencil_chain(dev, dtype):
    """[pw_up2_phase -> fused_up_block(phase_input)] equals [1x1 conv ->
    fused_up_block] on the card, at migan-512's top level widths."""
    from migan_tpu_torch.ops.conv import conv2d, pw_up2_phase

    rng = np.random.RandomState(23)
    n, hl, wl, ci, c, o = 2, 32, 48, 128, 64, 64
    y, w1 = _on(dev, _r(rng, n, hl, wl, ci), _r(rng, ci, c, scale=0.1),
                dtype=dtype)
    rest = _on(dev, *_up(rng, n, hl, wl, c, o)[1:7], dtype=dtype)
    want = fused_up_block(conv2d(y, w1[None, None]), *rest)
    for packed in (False, True):
        got = fused_up_block(pw_up2_phase(y, w1, packed=packed), *rest,
                             phase_input=True)
        _close(got, want, dtype)


def test_options_refuse_what_the_kernels_do_not_take(dev):
    """A 12-channel prologue input, a 4-channel input without the
    prologue, a prologue window larger than a block's shared memory, a
    skip 4 bytes off 16-byte alignment, a phase input of 4C + 2
    channels: each raises before a launch."""
    rng = np.random.RandomState(29)
    before = (_launches(sepconv), _launches(upblock))
    c = 64
    w = _on(dev, *_sep(rng, c, c))
    for cin, prologue, match in ((12, True, "multiples of 8"),
                                 (4, False, "shapes"),
                                 (2048, True, "shared memory")):
        x = _on(dev, _r(rng, 1, 8, 8, cin))[0]
        kw = _on_kw(dev, _options(rng, "prologue", x, c), torch.float32) \
            if prologue else {}
        with pytest.raises(ValueError, match=match):
            fused_block(x, *w, **kw)
    x = _on(dev, _r(rng, 1, 8, 8, c))[0]
    skip = torch.zeros(x.numel() + 1, device=dev)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_block(x, *w, skip=skip)
    args = _on(dev, *_phase_args(rng, 1, 4, 4, 8, 8))
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_up_block(args[0][..., :-2].contiguous(), *args[1:],
                       phase_input=True)
    assert (_launches(sepconv), _launches(upblock)) == before


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
    the chain's float32 plain convs (fromrgb, the 4x4 level's torgb, the
    rgb pyramid) and the detectors of the serve and evaluate CLIs run in
    IEEE float32, as the kernels do."""
    from migan_tpu_torch.cli.demo import load_model

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    load_model("migan-256", _weights(tmp_path, 256), "float32", "cuda")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("res,n,h,w", [(256, 1, 256, 256),
                                       (512, 2, 512, 384)])
def test_kernel_chain_matches_plain_on_card(dev, res, n, h, w):
    """The kernel chain, every level from the top down to the 4x4 one
    through the kernels, against the plain forward on the card in
    float32: migan-256 at N = 1 (one image a call), and migan-512 at a
    non-square input, whose noise is cropped at every level."""
    from migan_tpu_torch.cli.trace import seeded_generator
    from migan_tpu_torch.models.migan_inference import generator_apply
    from migan_tpu_torch.models.migan_kernels import KernelGenerator
    from migan_tpu_torch.ops.kernels import reset_launch_counts

    g = seeded_generator(res, res + 1).to(dev).eval()
    rng = np.random.RandomState(res)
    x = _on(dev, _r(rng, n, h, w, 4, scale=0.5))[0]
    reset_launch_counts()
    got = KernelGenerator(g)(x)
    torch.cuda.synchronize()
    k = int(np.log2(res))
    assert launch_counts() == {"sepconv": 2 * k, "downblock": k - 2,
                               "upblock": k - 2}
    want = generator_apply(g, x)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)


def test_served_replies_match_direct_program(dev, tmp_path):
    """migan-256 behind the port's server on the card: 6 concurrent
    requests, batched, each reply within 1 uint8 of the direct program
    at N = 1, and 28 kernel launches per dispatch."""
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
    assert counts == {"sepconv": 16 * len(served),
                      "downblock": 6 * len(served),
                      "upblock": 6 * len(served)}
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


# ---------------------------------------------------------------------------
# The kernels as custom ops, and torch.export on the card
# ---------------------------------------------------------------------------

# one migan-512 shape per kernel: (kernel, H, W, C, O), H and W the input's
OP_SHAPES = [("sepconv", 512, 512, 64, 64), ("downblock", 32, 32, 512, 512),
             ("upblock", 32, 32, 512, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", OP_SHAPES, ids=lambda s: s[0])
def test_custom_ops_equal_their_ctypes_launch(dev, shape, dtype):
    """`torch.ops.migan.*` dispatches to the same ctypes launch as before
    it was an op: bit for bit, one count per call."""
    kernel, h, w, c, o = shape
    rng = np.random.RandomState(h + c)
    if kernel == "upblock":
        args = [*_on(dev, *_up(rng, 1, h, w, c, o), dtype=dtype), True,
                False, None]
        op = torch.ops.migan.fused_up_block
    else:
        args = _on(dev, _r(rng, 1, h, w, c), *_sep(rng, c, o), dtype=dtype)
        if kernel == "sepconv":
            args += [None, True, None, None, None]
        op = {"sepconv": torch.ops.migan.fused_block,
              "downblock": torch.ops.migan.fused_down_block}[kernel]
    mod = {"sepconv": sepconv, "downblock": downblock,
           "upblock": upblock}[kernel]
    before = _launches(mod)
    via_op = op(*args)
    torch.cuda.synchronize()
    assert _launches(mod) == before + 1
    direct = launch.launch(mod.KERNEL, tuple(args))
    if kernel != "upblock":
        via_op, direct = (via_op,), (direct,)
    for a, b in zip(via_op, direct):
        assert torch.equal(a, b)


def test_exported_chain_runs_the_kernels_on_card(dev, tmp_path):
    """A `.pt2` of a migan-64 kernel chain, exported and loaded on the
    card: the loaded program launches the chain's kernels (12 sepconv, 4
    downblock, 4 upblock per forward) and equals the live chain
    exactly."""
    from migan_tpu_torch.cli.demo import load_model
    from migan_tpu_torch.export import torch_export
    from migan_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    forward, res = load_model("migan-64", _weights(tmp_path, 64),
                              device="cuda")
    rng = np.random.RandomState(64)
    x = torch.from_numpy(rng.randn(1, 64, 64, 4).astype(np.float32)).cuda()
    torch_export.save(str(tmp_path / "m.pt2"), forward, [x])
    loaded = torch_export.load(str(tmp_path / "m.pt2"))
    want = forward(x)
    reset_launch_counts()
    got = loaded(x)
    torch.cuda.synchronize()
    assert launch_counts() == {"sepconv": 12, "downblock": 4, "upblock": 4}
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The two launch paths: direct calls and the op
# ---------------------------------------------------------------------------

class _ThroughTheOp(TorchFunctionMode):
    """A mode that changes nothing but, being a mode, sends every wrapper
    call through its op."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


FUSED = {"sepconv": fused_block, "downblock": fused_down_block,
         "upblock": fused_up_block}


def _paths_bit_equal(kernel, args, **kw):
    """The wrapper's direct launch and its launch through the op: bit
    for bit, one launch each, only the first counted as direct."""
    reset_launch_counts()
    direct = FUSED[kernel](*args, **kw)
    torch.cuda.synchronize()
    assert launch_counts()[kernel] == direct_launch_counts()[kernel] == 1
    with _ThroughTheOp():
        via_op = FUSED[kernel](*args, **kw)
    torch.cuda.synchronize()
    assert launch_counts()[kernel] == 2
    assert direct_launch_counts()[kernel] == 1
    assert len(_outs(direct)) == len(_outs(via_op))
    for a, b in zip(_outs(direct), _outs(via_op)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MAIN_SHAPES,
                         ids=lambda s: "{}-{}x{}-{}to{}-{}".format(*s))
def test_direct_path_equals_op_path_at_main_shapes(dev, shape, dtype):
    """Every kernel shape of a migan-512 forward at N = 1 (sepconv with
    its noise, upblock with both outputs), direct and through the op."""
    kernel, h, w, c, o, final_act = shape
    rng = np.random.RandomState(h + c + o)
    if kernel == "upblock":
        args = _on(dev, *_up(rng, 1, h, w, c, o), dtype=dtype)
    else:
        args = _on(dev, _r(rng, 1, h, w, c), *_sep(rng, c, o), dtype=dtype)
    if kernel == "sepconv":
        args += [*_on(dev, _r(rng, h, w, scale=0.1), dtype=dtype),
                 final_act]
    _paths_bit_equal(kernel, args)


def _option_args(dev, option, dtype):
    """(kernel, arguments, keywords) of one kernel option."""
    rng = np.random.RandomState(len(option))
    if option == "sep_skip_4x4":
        x, skip = _on(dev, _r(rng, 1, 4, 4, 512), _r(rng, 1, 4, 4, 512),
                      dtype=dtype)
        return "sepconv", [x, *_on(dev, *_sep(rng, 512, 512),
                                   dtype=dtype)], {"skip": skip}
    if option == "sep_prologue":
        x = _r(rng, 2, 64, 64, 4)
        kw = _on_kw(dev, _options(rng, "both", x, 64), dtype)
        return "sepconv", _on(dev, x, *_sep(rng, 64, 64), dtype=dtype), kw
    if option == "sep_no_act":
        return "sepconv", _on(dev, _r(rng, 1, 16, 16, 512),
                              *_sep(rng, 512, 512), dtype=dtype), \
            {"final_act": False}
    if option == "up_phase":
        return "upblock", _on(dev, *_phase_args(rng, 1, 16, 16, 128, 128),
                              dtype=dtype), {"phase_input": True}
    x_lo, skip, n1, w_dw, b_dw, w_pw, n2, w_rgb, b_rgb = _on(
        dev, *_up(rng, 1, 32, 32, 64, 64), dtype=dtype)
    if option == "up_rgb_only":
        return "upblock", [x_lo, skip, n1, w_dw, b_dw, w_pw, n2, w_rgb,
                           b_rgb], {"emit_features": False}
    if option.startswith("up_rgb_fold"):
        # 32 x 32 -> 64 at N = 1: one output tile; at 8 x 8 -> 512 eight
        if option.endswith("8_tiles"):
            x_lo, skip, n1, w_dw, b_dw, w_pw, n2, w_rgb, b_rgb = _on(
                dev, *_up(rng, 1, 8, 8, 512, 512), dtype=dtype)
        img = _on(dev, _r(rng, *x_lo.shape[:3], 3), dtype=dtype)[0]
        return "upblock", [x_lo, skip, n1, w_dw, b_dw, w_pw, n2, w_rgb,
                           b_rgb], {"emit_features": "only" not in option,
                                    "img_lo": img}
    return "upblock", [x_lo, skip, n1, w_dw, b_dw, w_pw], {}   # features


DIRECT_OPTIONS = ["sep_skip_4x4", "sep_prologue", "sep_no_act", "up_phase",
                  "up_rgb_only", "up_features_only", "up_rgb_fold",
                  "up_rgb_fold_only", "up_rgb_fold_8_tiles"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("option", DIRECT_OPTIONS)
def test_direct_path_equals_op_path_with_options(dev, option, dtype):
    """The kernels' options, direct and through the op (with img_lo, one
    fold counted on each path)."""
    kernel, args, kw = _option_args(dev, option, dtype)
    _paths_bit_equal(kernel, args, **kw)
    assert rgb_fold_count() == (2 if "img_lo" in kw else 0)


def _misaligned_on(dev, shape):
    """A contiguous float32 tensor of `shape` on the card, 4 bytes off
    16-byte alignment."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, device=dev)[1:].view(shape)


@pytest.mark.parametrize("bad", ["width", "alignment", "device"])
@pytest.mark.parametrize("kernel", ["sepconv", "downblock", "upblock"])
def test_direct_and_op_paths_raise_alike_on_card(dev, kernel, bad):
    """What a kernel does not take (a width that is no multiple of 8, a
    misaligned input, a weight left on the CPU) raises the same exception
    type and message on both paths, at a key's first call and at repeated
    ones, and launches nothing."""
    rng = np.random.RandomState(3)
    c = 12 if bad == "width" else 16
    if kernel == "upblock":
        args = _on(dev, *_up(rng, 1, 4, 4, c, 16))[:6]
    else:
        args = _on(dev, _r(rng, 1, 8, 8, c), *_sep(rng, c, 16))
    if bad == "alignment":
        args[0] = _misaligned_on(dev, args[0].shape)
    if bad == "device":
        args[3] = args[3].cpu()
    errors = []
    reset_launch_counts()
    for through_op in (False, False, True, True):
        with pytest.raises(Exception) as info:
            if through_op:
                with _ThroughTheOp():
                    FUSED[kernel](*args)
            else:
                FUSED[kernel](*args)
        errors.append((type(info.value), str(info.value)))
    assert len(set(errors)) == 1, errors
    assert sum(launch_counts().values()) == 0


def test_direct_launches_per_forward_and_none_through_export(dev, tmp_path):
    """An eager migan-256 forward at N = 1 launches 16 / 6 / 6, each one
    direct; `torch.export` launches nothing, and its loaded `.pt2`
    launches through the ops, none of them direct."""
    from migan_tpu_torch.cli.demo import load_model
    from migan_tpu_torch.export import torch_export

    forward, res = load_model("migan-256", _weights(tmp_path, 256),
                              device="cuda")
    x = _on(dev, _r(np.random.RandomState(256), 1, res, res, 4))[0]
    want = {"sepconv": 16, "downblock": 6, "upblock": 6}
    reset_launch_counts()
    eager = forward(x)
    torch.cuda.synchronize()
    assert launch_counts() == direct_launch_counts() == want
    reset_launch_counts()
    torch_export.save(str(tmp_path / "m.pt2"), forward, [x])
    assert set(direct_launch_counts().values()) == {0}
    loaded = torch_export.load(str(tmp_path / "m.pt2"))
    reset_launch_counts()
    got = loaded(x)
    torch.cuda.synchronize()
    assert launch_counts() == want
    assert set(direct_launch_counts().values()) == {0}
    assert torch.equal(got, eager)


def test_profiled_forward_shows_the_ops_events(dev, tmp_path):
    """A profiled migan-256 forward leaves 28 `migan::` CPU events, whose
    names, shapes, scalars and dtypes equal those of the same forward
    through the ops; neither path leaves a `migan::` device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from migan_tpu_torch.cli.demo import load_model

    forward, res = load_model("migan-256", _weights(tmp_path, 256),
                              device="cuda")
    x = _on(dev, _r(np.random.RandomState(7), 1, res, res, 4))[0]
    forward(x)
    seen = {}
    for path in ("direct", "op"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            if path == "op":
                with _ThroughTheOp():
                    forward(x)
            else:
                forward(x)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.name.startswith("migan::")]
        seen[path] = (
            [(e.name, e.input_shapes, e.concrete_inputs,
              getattr(e, "input_dtypes", None)) for e in events
             if e.device_type == DeviceType.CPU],
            sorted(e.name for e in events
                   if e.device_type != DeviceType.CPU))
    assert len(seen["direct"][0]) == 28
    assert seen["direct"] == seen["op"]
    assert not seen["direct"][1]


NO_DYNAMO_ON_CARD = r"""
import sys
import torch
from migan_tpu_torch.cli.demo import load_model
forward, res = load_model("migan-256", sys.argv[1], device="cuda")
y = forward(torch.zeros(1, res, res, 4, device="cuda"))
torch.cuda.synchronize()
assert y.shape == (1, res, res, 3)
print("dynamo" if "torch._dynamo" in sys.modules else "clean")
"""


def test_first_forward_on_card_leaves_dynamo_unimported(dev, tmp_path):
    """A fresh interpreter loads migan-256 on the card and runs a forward
    without importing `torch._dynamo`."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", NO_DYNAMO_ON_CARD,
                        _weights(tmp_path, 256)], cwd=repo,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1] == "clean", r.stdout


# ---------------------------------------------------------------------------
# the fused training call: CUDA-graph replays of the train step
# ---------------------------------------------------------------------------

def _fused_setup(dev):
    """A 16 px training state on the card at step 2 (R1 every 3 steps),
    its `TrainStep` with a small KD teacher, and 6 steps' batches (uint8
    wire format) with the loop's seeds."""
    from migan_tpu_torch.models import comodgan, migan
    from migan_tpu_torch.train import loop, loss, train_step

    net = migan.MiganConfig(resolution=16, ch_base=512, depthwise=True,
                            reparametrize=True, num_reparam_tensors=2)
    gen = torch.Generator().manual_seed(0)
    G = migan.generator_init(net, gen).to(dev)
    D = migan.discriminator_init(net, gen).to(dev)
    teacher = comodgan.generator_init(
        comodgan.CoModGANConfig(resolution=16, ch_base=128, ch_max=32),
        gen).to(dev).eval().requires_grad_(False)
    cfg = train_step.TrainConfig(
        batch_size=4, ema_kimg=0.01, ema_rampup=0.05,
        d_opt=train_step.OptConfig(reg_interval=3),
        loss=loss.LossConfig(kd=loss.KDConfig(start_resolution=8)))
    state = train_step.state_from_modules(G, D, cfg)
    state.step = 2
    step = train_step.make_train_step(
        net, net, cfg,
        teacher=(comodgan.make_teacher_apply(teacher.cfg), teacher))
    rng = np.random.RandomState(1)
    real = torch.from_numpy(rng.randint(0, 256, (6, 4, 16, 16, 3),
                                        np.uint8)).to(dev)
    mask = torch.from_numpy((rng.rand(6, 4, 16, 16, 1) > 0.4).astype(
        np.uint8)).to(dev)
    seeds = [loop.step_seed(0, 2 + i) for i in range(6)]
    return state, step, real, mask, seeds


def test_fused_replays_equal_the_sequential_steps(dev):
    """2 calls of 3 steps (R1 at steps 3 and 6, inside each call; the
    EMA's beta ramped up, so it moves from step to step) against 6
    sequential steps with the loop's generators, under deterministic
    algorithms: G, D, the EMA, both Adam states and the stats equal bit
    for bit; each R1 pattern was captured once."""
    import copy

    from migan_tpu_torch.train import train_step

    torch.use_deterministic_algorithms(True)
    try:
        state_a, step, real, mask, seeds = _fused_setup(dev)
        state_b = copy.deepcopy(state_a)
        rows = []
        for i in range(6):
            do = state_a.step % 3 == 0
            rows.append(step(state_a, {"real": real[i], "mask": mask[i]},
                             torch.Generator(dev).manual_seed(seeds[i]),
                             do_dr1=do))
        fused = train_step.FusedTrainStep(step, 3, dev)
        got = [fused(state_b, {"real": real[c * 3:c * 3 + 3],
                               "mask": mask[c * 3:c * 3 + 3]},
                     seeds[c * 3:c * 3 + 3]) for c in range(2)]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert sorted(fused.capture_s) == [False, True]
    assert state_b.step == state_a.step == 8
    a, b = state_a.state_dict(), state_b.state_dict()
    for name in ("params_G", "params_D", "params_G_ema"):
        for k, v in a[name].items():
            assert torch.equal(b[name][k], v), (name, k)
    for name in ("opt_G", "opt_D"):
        for i, st in a[name]["state"].items():
            for k, v in st.items():
                assert torch.equal(b[name]["state"][i][k], v), (name, i, k)
    ran = torch.cat([g[train_step.R1_RAN] for g in got]).tolist()
    assert ran == [0, 1, 0, 0, 1, 0]
    for i, stats in enumerate(rows):
        for k, v in stats.items():
            assert torch.equal(got[i // 3][k][i % 3], v.float()), (i, k)


def test_fused_capture_that_fails_raises(dev, monkeypatch):
    """A step that reads a value to the host cannot be captured: the call
    raises, and no step ran eagerly in its place."""
    from migan_tpu_torch.train import train_step

    state, step, real, mask, seeds = _fused_setup(dev)
    orig = train_step.TrainStep.run

    def run(self, *a, **kw):
        stats = orig(self, *a, **kw)
        float(stats["Loss/G/loss"])           # a host read
        return stats

    monkeypatch.setattr(train_step.TrainStep, "run", run)
    before = {k: v.clone() for k, v in state.G.state_dict().items()}
    fused = train_step.FusedTrainStep(step, 3, dev)
    with pytest.raises(RuntimeError):
        fused(state, {"real": real[:3], "mask": mask[:3]}, seeds[:3])
    torch.cuda.synchronize()
    assert state.step == 2 and state.nimg == 0
    for k, v in state.G.state_dict().items():
        assert torch.equal(v, before[k]), k
