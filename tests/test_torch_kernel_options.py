"""The fused kernels' options in the port against the JAX package:
`fused_block`'s skip and pointwise prologue, `fused_up_block`'s phase
input, and `ops/conv.py::pw_up2_phase`.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the Pallas kernel run with interpret=True (or the JAX package's own plain
composition, `_xla_block`, where the JAX tests use it) at the shapes and
tolerances of tests/test_pallas_{sepconv,upblock}.py: rtol 1e-4, atol
1e-5 (1e-4 for the wide prologue, 1e-5 for pw_up2_phase), float32 sums
of the same taps in another order. The CUDA kernels' options are tested
on the card by tests/test_torch_cuda.py.
"""

import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from migan_tpu.ops.conv import pw_up2_phase as j_pw_up2_phase
from migan_tpu.ops.pallas.sepconv import _xla_block
from migan_tpu.ops.pallas.sepconv import fused_block as j_sep
from migan_tpu.ops.pallas.upblock import fused_up_block as j_up
from migan_tpu_torch.cli import fir_fold
from migan_tpu_torch.ops.conv import conv2d, pw_up2_phase
from migan_tpu_torch.ops.kernels import fused_block, fused_up_block
from migan_tpu_torch.ops.kernels import sepconv, upblock


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _sep_weights(rng, c, o, pw_scale=0.3):
    """HWIO weights as the JAX tests make them: w_dw [3,3,1,C], b_dw [C],
    w_pw [1,1,C,O]."""
    return (rng.randn(3, 3, 1, c).astype(np.float32) * 0.3,
            rng.randn(c).astype(np.float32),
            rng.randn(1, 1, c, o).astype(np.float32) * pw_scale)


def _port(w_dw, b_dw, w_pw):
    """The kernels' layout: [3,3,C], [C], [C,O]."""
    return _t(w_dw[:, :, 0]), _t(b_dw), _t(w_pw[0, 0])


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# fused_block: skip and the pointwise prologue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("has_skip,has_pre", [(True, False), (False, True),
                                              (True, True)],
                         ids=["skip", "prologue", "both"])
def test_fused_block_options_vs_pallas(has_skip, has_pre):
    """tests/test_pallas_sepconv.py::test_fused_block_kernel_path_variants
    (Cin = C = 128 -> 64, with noise) through the port."""
    n, h, w, c, o = 2, 32, 32, 128, 64
    rng = np.random.RandomState(3)
    x = rng.randn(n, h, w, c).astype(np.float32)
    wts = _sep_weights(rng, c, o)
    rng = np.random.RandomState(4)
    skip = rng.randn(n, h, w, c).astype(np.float32) if has_skip else None
    w_pre = (rng.randn(c, c).astype(np.float32) * 0.1) if has_pre else None
    b_pre = (rng.randn(c).astype(np.float32) * 0.1) if has_pre else None
    noise = rng.randn(h, w).astype(np.float32) * 0.1
    want = np.asarray(j_sep(*_j(x, *wts), noise=jnp.asarray(noise),
                            skip=_j(skip)[0], w_pre=_j(w_pre)[0],
                            b_pre=_j(b_pre)[0], interpret=True))
    opt = {k: None if v is None else _t(v)
           for k, v in (("skip", skip), ("w_pre", w_pre), ("b_pre", b_pre))}
    got = fused_block(_t(x), *_port(*wts), _t(noise), **opt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_wide_prologue_vs_pallas():
    """tests/test_pallas_sepconv.py::test_wide_prologue_kernel_path: the
    prologue at Cin = 8 -> 128 (the TPU's `pre_g` lane layout of it)."""
    n, h, w, cin, c, o = 2, 32, 32, 8, 128, 128
    rng = np.random.RandomState(31)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    w_pre = rng.randn(1, 1, cin, c).astype(np.float32) * 0.2
    b_pre = rng.randn(c).astype(np.float32) * 0.1
    w_dw = rng.randn(3, 3, 1, c).astype(np.float32) * 0.3
    b_dw = rng.randn(c).astype(np.float32)
    w_pw = rng.randn(1, 1, c, o).astype(np.float32) * 0.2
    want = np.asarray(j_sep(*_j(x, w_dw, b_dw, w_pw), w_pre=jnp.asarray(
        w_pre), b_pre=jnp.asarray(b_pre), interpret=True))
    got = fused_block(_t(x), *_port(w_dw, b_dw, w_pw), w_pre=_t(w_pre[0, 0]),
                      b_pre=_t(b_pre)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _prologue_case(seed, cin, b_pre_shift=0.0, n=2, h=24, w=40, c=64, o=32):
    """x, skip [n,h,w,cin], the sepconv weights, w_pre [cin,c], b_pre [c]
    and noise, as numpy float32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    skip = rng.randn(n, h, w, cin).astype(np.float32)
    wts = _sep_weights(rng, c, o)
    w_pre = rng.randn(cin, c).astype(np.float32) * cin ** -0.5
    b_pre = rng.randn(c).astype(np.float32) * 0.1 + b_pre_shift
    noise = rng.randn(h, w).astype(np.float32) * 0.1
    return x, skip, wts, w_pre, b_pre, noise


@pytest.mark.parametrize("with_skip", [False, True])
def test_prologue_at_cin_4_vs_xla_block(with_skip):
    """The generator's 4-channel input (mask, rgb) through the prologue,
    against the JAX package's composition `_xla_block`."""
    x, skip, wts, w_pre, b_pre, noise = _prologue_case(7, 4)
    skip = skip if with_skip else None
    want = np.asarray(_xla_block(*_j(x, wts[0][:, :, 0], wts[1],
                                     wts[2][0, 0], noise, skip, w_pre,
                                     b_pre)))
    got = fused_block(_t(x), *_port(*wts), _t(noise),
                      skip=None if skip is None else _t(skip),
                      w_pre=_t(w_pre), b_pre=_t(b_pre)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_prologue_zero_pads_its_output():
    """The dw's zero padding applies to the prologue's output: with a
    large b_pre the border rows and columns equal `_xla_block`'s, and
    differ from a prologue run on zero-padded x (act(b_pre) on the
    padding, not 0), so the comparison would catch that mistake."""
    x, _, wts, w_pre, b_pre, _ = _prologue_case(9, 4, b_pre_shift=3.0)
    w_dw, b_dw, w_pw = _port(*wts)
    want = np.asarray(_xla_block(*_j(x, wts[0][:, :, 0], wts[1],
                                     wts[2][0, 0], None, None, w_pre,
                                     b_pre)))
    got = fused_block(_t(x), w_dw, b_dw, w_pw, w_pre=_t(w_pre),
                      b_pre=_t(b_pre)).numpy()
    xp = torch.nn.functional.pad(_t(x), (0, 0, 1, 1, 1, 1))
    z = sepconv.ACT(xp @ _t(w_pre) + _t(b_pre))
    y = sepconv.ACT(conv2d(z, w_dw[:, :, None, :], groups=64) + b_dw)
    wrong = sepconv.ACT(conv2d(y, w_pw[None, None])).numpy()
    for border in (np.s_[:, [0, -1]], np.s_[:, :, [0, -1]]):
        assert np.abs(wrong[border] - want[border]).max() > 0.5
        np.testing.assert_allclose(got[border], want[border], rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("final_act", [True, False])
def test_prologue_composes_with_final_act(final_act):
    """The prologue and skip with and without the final act equal the
    composition written out: JAX has no final_act=False with a prologue,
    so this is held against the port's own ops."""
    x, skip, wts, w_pre, b_pre, noise = _prologue_case(11, 8)
    w_dw, b_dw, w_pw = _port(*wts)
    z = sepconv.ACT(conv2d(_t(x) + _t(skip), _t(w_pre)[None, None])
                    + _t(b_pre))
    want = sepconv.sepconv_plain(z, w_dw, b_dw, w_pw, _t(noise),
                                 final_act=final_act)
    got = fused_block(_t(x), w_dw, b_dw, w_pw, _t(noise), final_act,
                      skip=_t(skip), w_pre=_t(w_pre), b_pre=_t(b_pre))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# fused_up_block(phase_input=True) and pw_up2_phase
# ---------------------------------------------------------------------------

def _phase_case(seed=11):
    """tests/test_pallas_upblock.py::test_fused_up_block_phase_input's
    inputs: y [2,8,16,64], w_pw1 [64,128], then the up-block's."""
    n, hl, wl, ci, c, o = 2, 8, 16, 64, 128, 128
    rng = np.random.RandomState(seed)
    f = np.float32
    y = rng.randn(n, hl, wl, ci).astype(f)
    w_pw1 = rng.randn(1, 1, ci, c).astype(f) * 0.2
    skip = rng.randn(n, 2 * hl, 2 * wl, c).astype(f)
    nz_up = rng.randn(2 * hl, 2 * wl).astype(f) * 0.1
    w_dw = rng.randn(3, 3, 1, c).astype(f) * 0.3
    b_dw = rng.randn(c).astype(f)
    w_pw = rng.randn(1, 1, c, o).astype(f) * 0.2
    nz2 = rng.randn(2 * hl, 2 * wl).astype(f) * 0.1
    return y, w_pw1, skip, nz_up, (w_dw, b_dw, w_pw), nz2


def test_fused_up_block_phase_input_vs_pallas():
    """The phase input [2,8,16,4*128] from JAX's pw_up2_phase, through
    the Pallas kernel (interpret, tile_rows=4) and the port."""
    y, w_pw1, skip, nz_up, wts, nz2 = _phase_case()
    x4 = np.asarray(j_pw_up2_phase(jnp.asarray(y), jnp.asarray(w_pw1)))
    assert x4.shape == (2, 8, 16, 512)
    want = np.asarray(j_up(*_j(x4, skip, nz_up, *wts, nz2), interpret=True,
                           tile_rows=4, phase_input=True))
    got = fused_up_block(_t(x4), _t(skip), _t(nz_up), *_port(*wts),
                         _t(nz2), phase_input=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
def test_pw_up2_phase_vs_jax(packed):
    """Both forms (four 2x2 convs; one 3x3 conv) at the JAX test's
    shape."""
    rng = np.random.RandomState(3)
    y = rng.randn(2, 7, 9, 24).astype(np.float32)
    w = rng.randn(1, 1, 24, 16).astype(np.float32) * 0.2
    want = np.asarray(j_pw_up2_phase(jnp.asarray(y), jnp.asarray(w),
                                     packed=packed))
    got = pw_up2_phase(_t(y), _t(w), packed=packed).numpy()
    assert got.shape == (2, 7, 9, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
def test_phase_chain_equals_the_stencil_chain(packed):
    """[pw_up2_phase -> fused_up_block(phase_input)] = [1x1 conv ->
    fused_up_block], with torgb, in the port alone."""
    y, w_pw1, skip, nz_up, wts, nz2 = _phase_case(13)
    rng = np.random.RandomState(14)
    w_rgb = _t(rng.randn(128, 3).astype(np.float32) * 0.1)
    b_rgb = _t(rng.randn(3).astype(np.float32))
    rest = (_t(skip), _t(nz_up), *_port(*wts), _t(nz2), w_rgb, b_rgb)
    want = fused_up_block(conv2d(_t(y), _t(w_pw1)), *rest)
    got = fused_up_block(pw_up2_phase(_t(y), _t(w_pw1), packed=packed),
                         *rest, phase_input=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# refusals, the custom ops' options, the CLI
# ---------------------------------------------------------------------------

def test_options_refuse_what_they_cannot_compute():
    x, skip, wts, w_pre, b_pre, _ = _prologue_case(15, 8, n=1, h=6, w=6)
    sep = _port(*wts)
    for fn in (fused_block, sepconv.sepconv_plain):
        with pytest.raises(ValueError, match="both w_pre and b_pre"):
            fn(_t(x), *sep, w_pre=_t(w_pre))
        with pytest.raises(ValueError, match="both w_pre and b_pre"):
            fn(_t(x), *sep, b_pre=_t(b_pre))
        with pytest.raises(ValueError, match="skip"):
            fn(_t(x), *sep, skip=_t(skip[:, :5]), w_pre=_t(w_pre),
               b_pre=_t(b_pre))
        with pytest.raises(ValueError, match="w_pre"):
            fn(_t(x), *sep, w_pre=_t(w_pre[:4]), b_pre=_t(b_pre))
    y, _, skip, nz_up, wts, nz2 = _phase_case()
    x6 = torch.zeros(2, 8, 16, 4 * 128 + 2)
    for fn in (fused_up_block, upblock.upblock_plain):
        with pytest.raises(ValueError, match="multiple of 4"):
            fn(x6, _t(skip), _t(nz_up), *_port(*wts), phase_input=True)


def test_option_ops_pass_opcheck():
    """`torch.library.opcheck` of the ops with the options (the CPU
    kernel, the fake implementation's shapes, the schema)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    c, o = 8, 16
    sep = (r(3, 3, c), r(c), r(c, o))
    for args in ((r(2, 8, 6, 4), *sep, r(8, 6), True, r(2, 8, 6, 4),
                  r(4, c), r(c)),
                 (r(2, 8, 6, c), *sep, None, False, r(2, 8, 6, c), None,
                  None)):
        result = torch.library.opcheck(sepconv.fused_block_op, args)
        assert set(result.values()) == {"SUCCESS"}, result
    args = (r(2, 4, 3, 4 * c), r(2, 8, 6, c), r(8, 6), *sep, r(8, 6),
            r(o, 3), r(3), True, True)
    result = torch.library.opcheck(upblock.fused_up_block_op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_fir_fold_cli_on_cpu(capsys):
    """`cli/fir_fold.py --device cpu` at a small size: both levels in
    both dtypes, B and B2 held against A, the JAX script's keys, times
    not measured (null) off the card."""
    assert fir_fold.main(["--device", "cpu"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [(r["geometry"]["name"], r["dtype"]) for r in lines] == [
        ("b128", "float32"), ("b128", "bfloat16"),
        ("b64", "float32"), ("b64", "bfloat16")]
    for r in lines:
        assert all(k in r and r[k] is None for k in fir_fold.KEYS)
        assert r["device"] == "cpu"
        tol = 1e-4 if r["dtype"] == "float32" else 0.05
        assert r["B_vs_A_max_abs_diff"] < tol
        assert r["B2_vs_A_max_abs_diff"] < tol


def test_fir_fold_geometries_are_migan512s_top_levels():
    """The A/B runs at the port's unfolded widths: conv1's pointwise
    input Ci, the upblock's C and O, of the two top synthesis levels."""
    from migan_tpu_torch.models.migan_inference import GeneratorConfig

    geos = fir_fold.geometries(GeneratorConfig(resolution=512))
    assert geos == [
        {"name": "b512", "Hl": 256, "Wl": 256, "Ci": 128, "C": 64, "O": 64},
        {"name": "b256", "Hl": 128, "Wl": 128, "Ci": 256, "C": 128,
         "O": 128}]


class _WithOptions(torch.nn.Module):
    """A prologue block, then a phase-input upblock on its output."""

    def __init__(self, g):
        super().__init__()
        c, o = 8, 8
        for name, shape in (("w_pre", (4, c)), ("b_pre", (c,)),
                            ("w_dw", (3, 3, c)), ("b_dw", (c,)),
                            ("w_pw", (c, 4 * o)), ("w_dw2", (3, 3, o)),
                            ("b_dw2", (o,)), ("w_pw2", (o, o))):
            self.register_buffer(name, torch.randn(*shape, generator=g))

    def forward(self, x, skip, noise):
        x4 = fused_block(x, self.w_dw, self.b_dw, self.w_pw, w_pre=self.w_pre,
                         b_pre=self.b_pre, final_act=False)
        return fused_up_block(x4, skip, noise, self.w_dw2, self.b_dw2,
                              self.w_pw2, phase_input=True)


def test_export_keeps_the_options():
    """`torch.export` of a module calling the options records the two
    custom ops with them, and the program equals the eager module."""
    g = torch.Generator().manual_seed(1)
    m = _WithOptions(g)
    args = (torch.randn(2, 6, 5, 4, generator=g),
            torch.randn(2, 12, 10, 8, generator=g),
            torch.randn(12, 10, generator=g))
    program = torch.export.export(m, args)
    calls = {n.target: n for n in program.graph.nodes
             if n.op == "call_function"}
    sep = calls[torch.ops.migan.fused_block.default]
    up = calls[torch.ops.migan.fused_up_block.default]
    # (x, w_dw, b_dw, w_pw, noise, final_act, skip, w_pre, b_pre)
    assert [a.name for a in sep.args[7:]] == ["b_w_pre", "b_b_pre"]
    # (..., w_rgb, b_rgb, emit_features, phase_input)
    assert up.args[-1] is True
    torch.testing.assert_close(program.module()(*args), m(*args), rtol=0,
                               atol=0)
