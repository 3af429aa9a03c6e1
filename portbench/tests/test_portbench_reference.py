"""The plain reference against the program's own plain generator and its
serve path's pre- and post-processing, at small sizes on the CPU. (The
test imports the program; the reference does not.)"""

import io

import numpy as np
import pytest
import torch

from portbench.reference import generator as ref
from portbench.reference import serve as ref_serve
from portbench.reference import work
from portbench.traffic import images


@pytest.mark.parametrize("res, ch_base", [(32, 512), (64, 2048),
                                          (32, 32768)])
def test_generator_matches_the_program(res, ch_base):
    from migan_tpu_torch.io import load_pt
    from migan_tpu_torch.models.migan_inference import (
        GeneratorConfig, count_params, generator_apply)
    from migan_tpu_torch.models.migan_kernels import KernelGenerator

    cfg = dict(resolution=res, ch_base=ch_base, ch_max=512, ic_n=4,
               rgb_n=3)
    state = ref.seeded_state(cfg, 2 ** 31 + res, "cpu")
    g = load_pt(state, GeneratorConfig(resolution=res, ch_base=ch_base))
    assert ref.count_params(cfg) == sum(p.numel() for p in g.parameters())
    assert count_params(g) > ref.count_params(cfg)   # the FIR buffers
    x = torch.as_tensor(images.closed_pool(3, 2, res, 0.1, 0.5))
    want = ref.forward(cfg, state, x)
    for got in (generator_apply(g, x), KernelGenerator(g)(x)):
        assert (got - want).abs().max() < 1e-5
    assert want.std() > 0.05                         # not a trivial output


def test_seeded_state_is_the_seeds():
    cfg = dict(resolution=32, ch_base=512, ch_max=512, ic_n=4, rgb_n=3)
    a, b = (ref.seeded_state(cfg, 2 ** 40 + 1, "cpu") for _ in range(2))
    c = ref.seeded_state(cfg, 2 ** 40 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.b32.fromrgb.weight"],
                           c["encoder.b32.fromrgb.weight"])
    assert all(float(a[k]) != 0 for k in a if k.endswith("noise_strength"))


def test_flops_are_the_programs_count():
    from migan_tpu_torch.cli.calculate_flops import model_flops

    cfg = dict(resolution=256, ch_base=32768, ch_max=512, ic_n=4, rgb_n=3)
    assert work.generator_flops(cfg, 2) == model_flops("migan-256", 2)


@pytest.mark.parametrize("size", [(64, 48), (48, 64), (40, 40), (100, 30)])
def test_serve_processing_matches_the_program(size):
    from PIL import Image

    from migan_tpu_torch.cli.serve import _decode_request
    from migan_tpu_torch.data.preprocess import postprocess

    mix = dict(sizes=[list(size)], pool=4, hole=[0.2, 0.3], mask="stroke",
               jpeg_quality=90)
    body = images.body(5, mix, 1)
    x, img, mask = ref_serve.decode(body, 32)
    px, pimg, pmask = _decode_request(body, 32)
    np.testing.assert_array_equal(x, px)
    assert img.size == pimg.size and mask.size == pmask.size
    out = np.random.default_rng(0).uniform(-1.2, 1.2, (32, 32, 3)).astype(
        np.float32)
    want = ref_serve.reply(out, img, mask)
    buf = io.BytesIO()
    postprocess(out, pimg, pmask).save(buf, format="PNG")
    np.testing.assert_array_equal(ref_serve.read_png(buf.getvalue()), want)
    assert Image.open(io.BytesIO(buf.getvalue())).size == img.size
