"""Hand-written CUDA kernels for the three fused blocks of the main path,
with their plain PyTorch versions. Each launch adds one to the tracer's
counter `kernels.<kernel>.launches` (`utils/tracing.py`).

Each kernel is a `torch.library` custom op (`migan::fused_block`,
`migan::fused_down_block`, `migan::fused_up_block`), registered when this
package is imported, so a program that `torch.export` saves calls them by
name: import `migan_tpu_torch` before `torch.export.load` of such a
`.pt2`. Importing builds nothing; the library is compiled at the first
launch on a CUDA tensor (`_build.load_library`).
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


def reset_launch_counts() -> None:
    tracing.reset_counters("kernels.")


__all__ = ["fused_block", "fused_down_block", "fused_up_block",
           "launch_counts", "reset_launch_counts"]
