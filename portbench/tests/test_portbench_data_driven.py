"""A new cell, configuration, traffic mix, per-layer metric and kernel
description are new files and new entries in BENCHMARK.json: the harness
finds them by name, and runs the new cell, with no file of it edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_with_no_edit(tmp_path):
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    os.symlink(ROOT / "migan_tpu_torch", tmp_path / "migan_tpu_torch")
    before = _digests(tmp_path / "portbench")

    pb = tmp_path / "portbench"
    (pb / "configs" / "migan-32.json").write_text(json.dumps(dict(
        name="migan-32", model_name="migan-32", resolution=32,
        ch_base=32768, ch_max=512, ic_n=4, rgb_n=3, dtype="float32",
        reduced=[])))
    (pb / "traffic" / "pairs.json").write_text(json.dumps(dict(
        kind="closed_loop", batch=2, pool=4, hole=[0.2, 0.4],
        warmup_calls=1, trace_calls=1)))
    (pb / "workloads" / "migan32.pairs.json").write_text(json.dumps(
        {"sample_calls": 2, "numbers": {"rel_l2": {"limit": 1e-4}}}))
    (pb / "metrics" / "answer.py").write_text(
        "def read(r):\n    return 42.0\n")
    (pb / "metrics" / "kernels" / "newk.json").write_text(json.dumps(
        {"op": "migan::new_op", "device_names": ["new_kernel"]}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "migan-32", "source": "a test",
                             "file": "portbench/configs/migan-32.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "migan32.pairs", "config":
                               "migan-32", "traffic": "pairs", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "img_per_s_32", "unit": "img/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["migan32.pairs"]})
    bench["per_layer"].append({"name": "answer.of.pairs", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "img_per_s_32",
                               "workloads": ["migan32.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import json, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench import harness, readings, run as prun\n"
        "r = harness.load_run('migan32.pairs', 5, 0.5, False,"
        " device='cpu')\n"
        "print(json.dumps([r.config['name'], r.mix['batch'],"
        " [m['name'] for m in r.per_layer], [m['name'] for m in r.e2e],"
        " harness.reader('answer.of.pairs').read(None),"
        " sorted(readings.kernels()),"
        " not readings.plain_ops()('new_kernel<1>')]))\n"
        "r.e2e = [m for m in r.e2e if m['name'] == 'setup_s']\n"
        "print(json.dumps(prun.execute(r, time.perf_counter())))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    found, result = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert found == ["migan-32", 2, ["answer.of.pairs"],
                     ["setup_s", "img_per_s_32"], 42.0,
                     ["downblock", "newk", "sepconv", "upblock"], True]
    assert result["correct"] and result["attempted"] > 0
    after = _digests(tmp_path / "portbench")
    assert {k: after[k] for k in before} == before
