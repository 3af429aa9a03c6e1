"""What the readers of the program's own records share: the spans that
the program's tracer (`migan_tpu_torch.utils.tracing`) holds. A program
without that tracer has none, and its readers return None."""

from __future__ import annotations

from typing import List, Optional


def spans(name: str, setup: bool = False) -> list:
    """The tracer's spans named `name`: those recorded while a profiler
    ran (the traced stretch), or with `setup` the set-up spans."""
    try:
        from migan_tpu_torch.utils import tracing
    except ImportError:
        return []
    return [s for s in tracing.spans() if s.name == name
            and s.setup == setup]


def wall_s(name: str) -> List[float]:
    return [s.wall_ns / 1e9 for s in spans(name)]


def mean_ms(name: str) -> Optional[float]:
    """Mean wall ms of the stretch's spans named `name`."""
    w = wall_s(name)
    return 1e3 * sum(w) / len(w) if w else None


def share_pct(part: List[str], whole: List[str]) -> Optional[float]:
    """100 x the wall time of the spans named in `part` over that of
    those named in `whole`."""
    den = sum(sum(wall_s(n)) for n in whole)
    return 100.0 * sum(sum(wall_s(n)) for n in part) / den if den else None
