"""Nothing in a run loads JAX or the JAX package, and the reference loads
nothing of the program. Top-level module names are compared whole:
`migan_tpu_torch` is the program, `migan_tpu` the JAX package."""

import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench import harness

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _py(code: str) -> str:
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_source_names_jax(path):
    names = set(_imports(path))
    assert not names & set(harness.FORBIDDEN)
    if "reference" in path.parts:
        assert "migan_tpu_torch" not in names


def test_the_reference_loads_nothing_of_the_program():
    out = _py("import sys\n"
              "from portbench.reference import generator, serve, work\n"
              "from portbench import check\n"
              "print(sorted({m.split('.')[0] for m in sys.modules}))")
    tops = set(eval(out))
    assert "migan_tpu_torch" not in tops
    assert not tops & set(harness.FORBIDDEN)


def test_a_run_loads_the_program_and_no_jax():
    out = _py("import sys, torch\n"
              "torch.set_num_threads(2)\n"
              "from portbench.tests import tiny\n"
              "r = tiny.run(tiny.BATCH, 'migan512.batch16', seconds=0.5)\n"
              "from portbench import harness\n"
              "print(r['correct'], harness.forbidden_modules(),\n"
              "      'migan_tpu_torch' in sys.modules)")
    assert out.split("\n")[0] == "True [] True"


def test_names_are_compared_whole(monkeypatch):
    for name in ("migan_tpu_torch", "migan_tpu_torch.ops", "jaxtyping",
                 "flax_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "migan_tpu.models",
                        types.ModuleType("migan_tpu.models"))
    assert harness.forbidden_modules() == ["migan_tpu"]
