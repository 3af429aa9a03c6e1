"""The kernels' two launch paths, on the CPU.

A public wrapper (`fused_block`, `fused_down_block`, `fused_up_block`)
calls its implementation directly when nothing traces or records the
call, and its `torch.library` op otherwise. The direct call gives the
op's outputs, errors and profiler event. On CUDA both paths reach one
launcher, which keeps a record per key; here it runs with a stand-in for
the kernel library, so its checks, records and arguments are held without
a card (`tests/test_torch_cuda.py` holds the kernels themselves).

This file imports no JAX.
"""

import os
import subprocess
import sys

import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from migan_tpu_torch.models.migan_inference import (
    GeneratorConfig, generator_init)
from migan_tpu_torch.models.migan_kernels import KernelGenerator, kernel_shapes
from migan_tpu_torch.ops.kernels import (
    _build, downblock, launch, launch_counts, plan, reset_launch_counts,
    sepconv, upblock,
)
from migan_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODS = {"sepconv": sepconv, "downblock": downblock, "upblock": upblock}
OPS = {"sepconv": "fused_block_op", "downblock": "fused_down_block_op",
       "upblock": "fused_up_block_op"}
WRAPPERS = {"sepconv": sepconv.fused_block,
            "downblock": downblock.fused_down_block,
            "upblock": upblock.fused_up_block}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _r(g, *shape):
    return torch.randn(*shape, generator=g)


def _case(name: str):
    """(kernel, the op's arguments in its schema's order) of a named case:
    each kernel's options at a small size, channels multiples of 8."""
    g = torch.Generator().manual_seed(len(name))
    n, h, w, c, o = 2, 8, 6, 16, 24
    sep = (_r(g, 3, 3, c), _r(g, c), _r(g, c, o) * 0.3)
    x = _r(g, n, h, w, c)
    if name == "sep":
        return "sepconv", (x, *sep, None, True, None, None, None)
    if name == "sep_noise_no_act":
        return "sepconv", (x, *sep, _r(g, h, w), False, None, None, None)
    if name == "sep_skip":
        return "sepconv", (x, *sep, None, True, _r(g, n, h, w, c), None,
                           None)
    if name == "sep_prologue":
        x4 = _r(g, n, h, w, 4)
        return "sepconv", (x4, *sep, _r(g, h, w), True, _r(g, n, h, w, 4),
                           _r(g, 4, c), _r(g, c))
    if name == "down":
        return "downblock", (x, *sep)
    hl, wl = h // 2, w // 2
    up = (_r(g, n, hl, wl, c), x, _r(g, h, w) * 0.1, *sep)
    rgb = (_r(g, o, 3) * 0.2, _r(g, 3))
    img = _r(g, n, hl, wl, 3)
    if name == "up_feat":
        return "upblock", (*up, None, None, None, True, False, None)
    if name == "up_feat_rgb":
        return "upblock", (*up, _r(g, h, w) * 0.1, *rgb, True, False, None)
    if name == "up_rgb_only":
        return "upblock", (*up, _r(g, h, w) * 0.1, *rgb, False, False, None)
    if name == "up_phase":
        return "upblock", (_r(g, n, hl, wl, 4 * c), *up[1:], None, *rgb,
                           True, True, None)
    if name == "up_fold":
        return "upblock", (*up, _r(g, h, w) * 0.1, *rgb, True, False, img)
    if name == "up_fold_rgb_only":
        return "upblock", (*up, _r(g, h, w) * 0.1, *rgb, False, False, img)
    if name == "up_phase_fold":
        return "upblock", (_r(g, n, hl, wl, 4 * c), *up[1:], None, *rgb,
                           True, True, img)
    raise KeyError(name)


CASES = ["sep", "sep_noise_no_act", "sep_skip", "sep_prologue", "down",
         "up_feat", "up_feat_rgb", "up_rgb_only", "up_phase", "up_fold",
         "up_fold_rgb_only", "up_phase_fold"]


def _call(kernel, args):
    """The public wrapper on the op's arguments."""
    return WRAPPERS[kernel](*args)


def _op_call(kernel, args):
    """The op on the same arguments, with upblock's pair turned into what
    the wrapper returns."""
    out = getattr(MODS[kernel], OPS[kernel])(*args)
    if kernel != "upblock":
        return out
    feat, rgb = out
    emit, has_rgb = args[9], args[7] is not None
    return (feat, rgb) if has_rgb and emit else rgb if has_rgb else feat


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


# ---------------------------------------------------------------------------
# which path a call takes
# ---------------------------------------------------------------------------

class _PassDispatch(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


class _PassFunction(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


CONTEXTS = {          # context -> whether the wrapper calls its op
    "plain": False, "no_grad_with_grad_input": False, "fake": True,
    "dispatch_mode": True, "function_mode": True, "grad_input": True,
}


@pytest.mark.parametrize("context", sorted(CONTEXTS))
@pytest.mark.parametrize("kernel", sorted(MODS))
def test_wrappers_take_the_op_only_when_traced(kernel, context, monkeypatch):
    """Plain CPU tensors go straight to the plain version, also with an
    input that requires grad under no_grad; under FakeTensorMode, a
    TorchDispatchMode or a TorchFunctionMode, or with an input requiring
    grad while grad mode is on, the wrapper calls its op."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, args = _case({"sepconv": "sep_skip", "downblock": "down",
                     "upblock": "up_feat_rgb"}[kernel])
    mod, name = MODS[kernel], OPS[kernel]
    real, calls = getattr(mod, name), []

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(mod, name, spy)
    if context == "fake":
        mode = FakeTensorMode()
        args = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args)
        with mode:
            out = _call(kernel, args)
        assert all(type(t) is not torch.Tensor for t in _flat(out))
    elif context in ("grad_input", "no_grad_with_grad_input"):
        args = (args[0].clone().requires_grad_(), *args[1:])
        with torch.set_grad_enabled(context == "grad_input"):
            _call(kernel, args)
    elif context == "plain":
        _call(kernel, args)
    else:
        with (_PassDispatch() if context == "dispatch_mode"
              else _PassFunction()):
            _call(kernel, args)
    assert calls == ([1] if CONTEXTS[context] else [])


@pytest.mark.parametrize("case", CASES)
def test_direct_and_op_paths_agree(case):
    """The wrapper's direct call and the op give equal outputs."""
    kernel, args = _case(case)
    got, want = _flat(_call(kernel, args)), _flat(_op_call(kernel, args))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _bad(kernel):
    """Arguments whose shapes the kernel does not take."""
    _, args = _case({"sepconv": "sep", "downblock": "down",
                     "upblock": "up_feat"}[kernel])
    if kernel == "sepconv":       # a skip of another width than x
        return (*args[:6], args[0][..., :8].contiguous(), None, None)
    w_pw = args[-1] if kernel == "downblock" else args[5]
    wide = torch.zeros(w_pw.shape[0] + 8, w_pw.shape[1])
    if kernel == "downblock":
        return (*args[:3], wide)
    return (*args[:5], wide, *args[6:])


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("kernel", sorted(MODS))
def test_direct_and_op_paths_raise_alike(kernel):
    """A bad shape raises the same exception type and message on both
    paths, at a key's first call and at a repeated one."""
    args = _bad(kernel)
    errors = [_error(lambda: _call(kernel, args)) for _ in range(2)]
    errors += [_error(lambda: _op_call(kernel, args)) for _ in range(2)]
    assert len(set(errors)) == 1, errors


def _migan_events(prof):
    return [(e.name, e.input_shapes, e.concrete_inputs,
             getattr(e, "input_dtypes", None))
            for e in prof.events() if e.name.startswith("migan::")]


@pytest.mark.parametrize("case", CASES)
def test_direct_call_profiles_as_the_op(case):
    """Under a profiler recording shapes, a direct call's `migan::` event
    has the op's name, input shapes, concrete inputs and dtypes."""
    from torch.profiler import ProfilerActivity, profile

    kernel, args = _case(case)
    events = []
    for fn in (_call, _op_call):
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            fn(kernel, args)
        events.append(_migan_events(prof))
    assert len(events[0]) == 1, events
    assert events[0] == events[1]
    assert events[0][0][0] == MODS[kernel].OP


# ---------------------------------------------------------------------------
# the launcher, with a stand-in for the kernel library
# ---------------------------------------------------------------------------

STREAM = 0x5EED


class _StubLibrary:
    """The library's three entry points, each keeping its arguments and
    returning success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name not in _build.SIGNATURES:
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def stub(monkeypatch):
    """Launches on CPU tensors into `_StubLibrary`, from empty records."""
    lib = _StubLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(launch, "stream_handle", lambda index: STREAM)
    for mod in MODS.values():
        monkeypatch.setattr(mod.KERNEL, "records", {})
    return lib


def _p(t):
    return 0 if t is None else t.data_ptr()


def _expected(kernel, args, out):
    """The entry point's arguments as a launch computes them without a
    record: the plan of `plan.launch_plan`, pointers, sizes, stream (None
    pointers as 0)."""
    if kernel == "sepconv":
        x, w_dw, b_dw, w_pw, noise, final_act, skip, w_pre, b_pre = args
        n, h, w, cin = x.shape
        c, o = w_pw.shape
        mode = (plan.SEP_PROLOGUE if w_pre is not None else
                plan.SEP_SKIP if skip is not None else plan.SEP_PLAIN)
        p = plan.launch_plan("sepconv", n, h, w, o, x.dtype, mode=mode,
                             cin=cin)
        return ["migan_sepconv", 0, p.config, p.blocks, p.threads,
                p.smem_bytes, mode, _p(x), _p(skip), _p(w_pre), _p(b_pre),
                _p(w_dw), _p(b_dw), _p(w_pw), _p(noise), _p(out), n, h, w,
                cin, c, o, int(final_act), STREAM]
    if kernel == "downblock":
        x, w_dw, b_dw, w_pw = args
        n, hh, wh, c = x.shape
        o = w_pw.shape[1]
        p = plan.launch_plan("downblock", n, hh, wh, o, x.dtype)
        return ["migan_downblock", 0, p.config, p.blocks, p.threads,
                p.smem_bytes, *map(_p, (x, w_dw, b_dw, w_pw, out)), n, hh,
                wh, c, o, STREAM]
    (x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2, w_rgb, b_rgb, _,
     phase, img_lo) = args
    n, hl, wl, c = x_lo.shape
    o = w_pw.shape[1]
    mode = plan.UP_PHASE if phase else plan.UP_PLAIN
    p = plan.launch_plan("upblock", n, hl, wl, o, x_lo.dtype, mode=mode)
    feat, rgb = out
    assert p.out_tiles == 1            # so no rgb partials (pointer 0)
    return ["migan_upblock", 0, p.config, p.blocks, p.threads, p.smem_bytes,
            mode, *map(_p, (x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2,
                            w_rgb, b_rgb, img_lo, feat, rgb)), 0, n, hl, wl,
            c // 4 if phase else c, o, STREAM]


@pytest.mark.parametrize("case", CASES)
def test_launcher_passes_what_an_unrecorded_launch_would(case, stub):
    """The first launch of a key builds its record, the second hits it:
    both pass the entry point the plan, pointers and sizes computed
    afresh, allocate outputs of the right shapes, and count a launch, and
    an rgb fold where upblock is given img_lo."""
    from migan_tpu_torch.ops.kernels import rgb_fold_count

    kernel, args = _case(case)
    k = MODS[kernel].KERNEL
    before = launch_counts()[kernel]
    folds = rgb_fold_count()
    for i in range(2):
        out = launch.launch(k, args)
        name, got = stub.calls[-1]
        assert [name, *(0 if a is None else a for a in got)] == \
            _expected(kernel, args, out)
        assert len(k.records) == 1
    assert launch_counts()[kernel] == before + 2
    assert rgb_fold_count() == folds + (
        2 if kernel == "upblock" and args[11] is not None else 0)
    if kernel == "upblock":
        feat, rgb = out
        x_lo, emit, has_rgb = args[0], args[9], args[7] is not None
        hw = (2 * x_lo.shape[1], 2 * x_lo.shape[2])
        assert (feat is None) != emit and (rgb is None) != has_rgb
        if emit:
            assert feat.shape == (x_lo.shape[0], *hw, args[5].shape[1])
    else:
        assert out.shape == _call(kernel, args).shape


def _misaligned(t):
    """t's values in a contiguous tensor 4 bytes off 16-byte alignment."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype)
    start = next(i for i in range(4)
                 if (buf.data_ptr() + 4 * i) % 16 == 4)
    out = buf[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _strided(t):
    """t's values in a tensor of t's shape that is not contiguous."""
    return torch.stack([t, t], -1)[..., 0]


# what a call changes of good arguments: ({kernel: argument index},
# change, words of the error); only a change of x's shape gives the call
# another key. The three alignments are x's, w_pw's and skip's.
BREAKS = {
    "shape": ({"sepconv": 0, "downblock": 0, "upblock": 0},
              lambda x: x[..., :-8].contiguous(), "shapes"),
    "layout": ({"sepconv": 1, "downblock": 1, "upblock": 1}, _strided,
               "is not contiguous"),
    "dtype": ({"sepconv": 2, "downblock": 2, "upblock": 2},
              lambda t: t.double(), "is torch.float64, expected"),
    "x_alignment": ({"sepconv": 0, "downblock": 0, "upblock": 0},
                    _misaligned, "16-byte aligned"),
    "w_pw_alignment": ({"sepconv": 3, "downblock": 3, "upblock": 5},
                       _misaligned, "16-byte aligned"),
    "skip_alignment": ({"sepconv": 6, "upblock": 1}, _misaligned,
                       "16-byte aligned"),
}


@pytest.mark.parametrize("broken,kernel", [
    (b, k) for b in sorted(BREAKS) for k in sorted(BREAKS[b][0])])
def test_launcher_raises_alike_with_and_without_a_record(kernel, broken,
                                                         stub):
    """A call the kernel does not take raises the same exception type and
    message at a key's first call, at a repeated one, and at a call whose
    key a good call already recorded, and launches nothing."""
    _, args = _case({"sepconv": "sep_skip", "downblock": "down",
                     "upblock": "up_feat_rgb"}[kernel])
    k = MODS[kernel].KERNEL
    where, change, words = BREAKS[broken]
    i = where[kernel]
    bad = (*args[:i], change(args[i]), *args[i + 1:])
    first = [_error(lambda: launch.launch(k, bad)) for _ in range(2)]
    assert not k.records and not stub.calls
    launch.launch(k, args)
    recorded = _error(lambda: launch.launch(k, bad))
    assert len(stub.calls) == 1
    assert first[0] == first[1] == recorded, (first, recorded)
    assert words in first[0][1], first[0]


def test_direct_launches_are_counted_apart(stub):
    """A direct launch adds to both `kernels.<k>.launches` and
    `kernels.<k>.direct_launches`; `reset_launch_counts` zeroes both."""
    from migan_tpu_torch.ops.kernels import direct_launch_counts

    from migan_tpu_torch.ops.kernels import rgb_fold_count

    reset_launch_counts()
    for case in ("sep", "down", "up_feat_rgb", "up_fold"):
        kernel, args = _case(case)
        launch.direct_launch(MODS[kernel].KERNEL, args)
        launch.launch(MODS[kernel].KERNEL, args)
    assert launch_counts() == {"sepconv": 2, "downblock": 2, "upblock": 4}
    assert direct_launch_counts() == {"sepconv": 1, "downblock": 1,
                                      "upblock": 2}
    assert rgb_fold_count() == 2
    reset_launch_counts()
    assert set(direct_launch_counts().values()) == {0}
    assert rgb_fold_count() == 0
    assert not any(k.startswith("kernels.") for k in tracing.counters())


def test_records_stay_right_under_racing_threads(stub, monkeypatch):
    """16 threads launch sepconv at 6 keys, 3 records at most (so the
    records are dropped and built again while others read them), at a
    tiny switch interval: every launch passes its own key's plan and
    sizes, and none raises."""
    import threading

    monkeypatch.setattr(launch, "RECORDS_MAX", 3)
    g = torch.Generator().manual_seed(5)
    sep = (_r(g, 3, 3, 16), _r(g, 16), _r(g, 16, 24))
    xs = [_r(g, n, 8, 6, 16) for n in range(1, 7)]
    errors = []

    def work(i):
        try:
            for k in range(300):
                launch.launch(sepconv.KERNEL, (xs[(i + k) % 6], *sep, None,
                                               True, None, None, None))
        except Exception as e:             # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]
    assert len(stub.calls) == 16 * 300
    for _, args in stub.calls:
        n, h, w, cin, c, o, _ = args[15:22]
        p = plan.launch_plan("sepconv", n, h, w, o, torch.float32, cin=cin)
        assert args[:5] == (0, p.config, p.blocks, p.threads, p.smem_bytes)


def _shape_key(kernel, n, h, w, c, o, final_act, dtype):
    """A record's key for one `kernel_shapes` entry, from meta tensors."""
    def m(*shape):
        return torch.empty(*shape, dtype=dtype, device="meta")

    if kernel == "sepconv":
        return launch.key((m(n, h, w, c), m(3, 3, c), m(c), m(c, o),
                           m(h, w), final_act, None, None, None))
    if kernel == "downblock":
        return launch.key((m(n, h, w, c), m(3, 3, c), m(c), m(c, o)))
    hh, wh = 2 * h, 2 * w
    return launch.key((m(n, h, w, c), m(n, hh, wh, c), m(hh, wh),
                       m(3, 3, c), m(c), m(c, o), m(hh, wh), m(o, 3), m(3),
                       True, False, m(n, h, w, 3)))


@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("res", [256, 512])
def test_records_hold_the_plan_of_every_main_path_shape(res, n, stub):
    """For every launch of a migan-256 and migan-512 forward, in both
    dtypes, the record's plan is `plan.launch_plan`'s and its arguments
    carry it; upblock's, given img_lo as the chain gives it, holds img_lo
    among the tensors a later launch re-checks."""
    for kernel, h, w, c, o, final_act in kernel_shapes(
            GeneratorConfig(resolution=res)):
        for dtype in (torch.float32, torch.bfloat16):
            key = _shape_key(kernel, n, h, w, c, o, final_act, dtype)
            rec = launch.record(MODS[kernel].KERNEL, key)
            want = plan.launch_plan(kernel, n, h, w, o, dtype)
            assert rec.plan == want, (kernel, h, w, c, o)
            assert rec.head[:5] == (launch.DTYPE_CODES[dtype],
                                    want.config, want.blocks, want.threads,
                                    want.smem_bytes)
            assert rec.dtype is dtype and rec.index == -1
            if kernel == "upblock":          # every slot, img_lo's (11) too
                assert rec.tensors == MODS[kernel].KERNEL.tensors


# ---------------------------------------------------------------------------
# the generator: export keeps the ops, eager calls leave dynamo unloaded
# ---------------------------------------------------------------------------

KERNEL_OPS = {torch.ops.migan.fused_block.default,
              torch.ops.migan.fused_down_block.default,
              torch.ops.migan.fused_up_block.default}


@pytest.mark.parametrize("strict", [False, True], ids=["nonstrict", "strict"])
def test_export_keeps_every_kernel_op(strict):
    """Both `torch.export` modes record all 28 `migan::` calls of a
    migan-256 forward (narrow channels: the count follows the ladder)."""
    g = generator_init(GeneratorConfig(resolution=256, ch_base=2048,
                                       ch_max=16),
                       torch.Generator().manual_seed(0))
    chain = KernelGenerator(g)
    x = torch.zeros(1, 256, 256, 4)
    program = torch.export.export(chain, (x,), strict=strict)
    nodes = [n for m in program.graph_module.modules()
             if isinstance(m, torch.fx.GraphModule)
             for n in m.graph.nodes
             if n.op == "call_function" and n.target in KERNEL_OPS]
    assert len(nodes) == 28
    assert torch.equal(program.module()(x), chain(x))


NO_DYNAMO = r"""
import sys, tempfile
import torch
torch.set_num_threads(2)
from migan_tpu_torch.cli.demo import load_model
from migan_tpu_torch.cli.trace import seeded_generator
from migan_tpu_torch.io import save_npz
from migan_tpu_torch.ops.kernels import launch_counts
assert "torch._dynamo" not in sys.modules, "at import"
with tempfile.TemporaryDirectory() as d:
    save_npz(f"{d}/w.npz", seeded_generator(256, 0))
    forward, res = load_model("migan-256", f"{d}/w.npz", device="cpu")
    x = torch.zeros(1, res, res, 4)
    a, b = forward(x), forward(x)
assert torch.equal(a, b) and a.shape == (1, 256, 256, 3)
print("dynamo" if "torch._dynamo" in sys.modules else "clean")
"""


def test_eager_forwards_leave_dynamo_unimported():
    """A fresh interpreter loads migan-256 on the CPU and runs two
    forwards without importing `torch._dynamo`, which the op's first call
    imports."""
    r = subprocess.run([sys.executable, "-c", NO_DYNAMO], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1] == "clean", r.stdout
