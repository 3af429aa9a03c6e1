"""Hand-written CUDA kernels for the three fused blocks of the main path,
with their plain PyTorch versions.

Each kernel is a `torch.library` custom op (`migan::fused_block`,
`migan::fused_down_block`, `migan::fused_up_block`), registered when this
package is imported, so a program that `torch.export` saves calls them by
name: import `migan_tpu_torch` before `torch.export.load` of such a
`.pt2`. Importing builds nothing; the library is compiled at the first
launch on a CUDA tensor (`_build.load_library`).

A call takes one of two paths (`launch.call`). A public wrapper
(`fused_block`, `fused_down_block`, `fused_up_block`) skips the op's
dispatch when nothing traces or records the call (`launch.direct`: plain
tensors, no compile, export, mode or transform, no gradient asked for)
and calls the implementation itself: the launch on CUDA, the plain
version on the CPU. Otherwise it calls the op, whose CUDA implementation
is the same launch, so `torch.export` records the op and a `.pt2`
launches through it. While a profiler runs, a direct call opens a range
named as the op holding the op's arguments, so it leaves the op's event.
The direct path also keeps `torch._dynamo` unimported, which the op's
first call imports.

One launcher serves the three kernels (`launch.launch`); each kernel
module states what is its own as data (`launch.Kernel`: its check, the
layout of its key's record, its entry point's pointer order and the
arguments it needs aligned). A launch keeps a record per key (each of
the op's arguments as its shape, None or the flag, then dtype and
device; `launch.key`, `launch.Record`): the first launch of a key runs
every check and finds the plan (`plan.launch_plan`) and the constant
arguments; a later one checks only what the key leaves open (each
tensor's dtype, device, layout and alignment), allocates the outputs and
makes one ctypes call.

Each launch adds one to the tracer's counter `kernels.<kernel>.launches`
(`utils/tracing.py`), and a direct one also to
`kernels.<kernel>.direct_launches`: their ratio is the share of launches
that skipped the op. An upblock launch given the image of the level below
(`img_lo`) adds one to `kernels.upblock.rgb_folds`: its ratio to upblock's
launches is the share that folded the rgb pyramid's up-sample and add,
1.0 over a `KernelGenerator` forward.
"""

from ...utils import tracing
from .downblock import fused_down_block
from .sepconv import fused_block
from .upblock import fused_up_block

KERNELS = ("sepconv", "downblock", "upblock")


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    counts = tracing.counters()
    return {k: counts.get(f"kernels.{k}.launches", 0) for k in KERNELS}


def direct_launch_counts() -> dict:
    """{kernel name: launches since the last reset that skipped the op's
    dispatch}."""
    counts = tracing.counters()
    return {k: counts.get(f"kernels.{k}.direct_launches", 0)
            for k in KERNELS}


def rgb_fold_count() -> int:
    """Upblock launches since the last reset that folded the rgb
    pyramid's step (`img_lo`)."""
    return tracing.counters().get("kernels.upblock.rgb_folds", 0)


def reset_launch_counts() -> None:
    """Zero every launch count, the rgb folds' included."""
    tracing.reset_counters("kernels.")


__all__ = ["fused_block", "fused_down_block", "fused_up_block",
           "launch_counts", "direct_launch_counts", "rgb_fold_count",
           "reset_launch_counts"]
