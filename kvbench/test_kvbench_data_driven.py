"""The harness takes a new configuration, traffic mix, kind of draw and
metric as files: a copy of kvbench/ gains four files and BENCHMARK.json
three entries, no file of the copy changes, and the harness lists and runs
them."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from kvbench.conftest import SEED, TINY

CHECKOUT = Path(__file__).resolve().parent.parent

METRIC = '''"""batches_per_s: batches the window decided per second."""


def read(ctx):
    w = ctx["window"]
    return w["batches"] / w["seconds"]
'''


KIND = '''"""Requests "low_half": records uniform over the lower half."""

import numpy as np


def draw(rng, spec, records, shape):
    return rng.integers(0, records // 2, size=shape, dtype=np.int64)
'''


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file()
        and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path):
    shutil.copytree(CHECKOUT / "kvbench", tmp_path / "kvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "kvbench")
    kv = tmp_path / "kvbench"
    config = json.loads((kv / "configs" / "skiplisttest.json").read_text())
    config["name"] = "skiplisttest-2k"
    (kv / "configs" / "skiplisttest-2k.json").write_text(json.dumps(config))
    traffic = json.loads((kv / "traffic" / "2500.json").read_text())
    traffic.update(reads_per_txn=2, writes_per_txn=2,
                   requests={"distribution": "low_half"})
    (kv / "traffic" / "r2w2-1k.json").write_text(json.dumps(traffic))
    (kv / "metrics" / "batches_per_s.py").write_text(METRIC)
    (kv / "kinds" / "requests" / "low_half.py").write_text(KIND)

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cell = "skiplisttest-2k.r2w2-1k"
    bench["configs"].append(dict(bench["configs"][1], name="skiplisttest-2k",
                                 file="kvbench/configs/skiplisttest-2k.json"))
    bench["workloads"].append({"name": cell, "config": "skiplisttest-2k",
                               "traffic": "r2w2-1k", "chips": 1,
                               "why": "two range reads and writes a txn"})
    bench["end_to_end"].append({"name": "batches_per_s", "unit": "batches/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    over = TINY["skiplisttest.2500"]
    code = (
        "import json, kvbench; from kvbench import harness; "
        "b = harness.load_benchmark(); "
        f"r = harness.run_cell(b, {cell!r}, {SEED}, 0.3, False, "
        f"device='cpu', overrides={over!r}); "
        "print(json.dumps({'file': kvbench.__file__, 'correct': r['correct'],"
        f" 'metrics': sorted(r['metrics']), 'listed': [m['name'] for m in "
        f"harness.metrics_of(b, {cell!r}, False)]}}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(CHECKOUT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(tmp_path))
    assert got["correct"]
    assert got["listed"] == ["txns_per_s", "resolve_ms_p99", "setup_s",
                             "batches_per_s"]
    assert got["metrics"] == sorted(got["listed"])
    after = _digests(kv)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "configs/skiplisttest-2k.json", "traffic/r2w2-1k.json",
        "metrics/batches_per_s.py", "kinds/requests/low_half.py"}
