"""The run log: stdout teed to the run's log file (port of
`migan_tpu/utils/logging.py`; reference lib/log_service.py). The JAX
package's trace annotations became the spans of `utils/tracing.py`."""

from __future__ import annotations

import os
from typing import Optional

_log_file: Optional[str] = None


def set_log_file(path: Optional[str]) -> None:
    """Append every later `print_log` line to `path` (None: stdout only)."""
    global _log_file
    _log_file = path
    if path:
        os.makedirs(os.path.dirname(path), exist_ok=True)


def print_log(*console_info) -> None:
    """Print to stdout and append to the run log
    (reference lib/log_service.py:4-18)."""
    text = " ".join(str(i) for i in console_info)
    print(text, flush=True)
    if _log_file is not None:
        with open(_log_file, "a") as f:
            f.write(text + "\n")

