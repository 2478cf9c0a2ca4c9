"""What a run loads: nothing of JAX or of the JAX package, compared by
the whole top-level name (the port's name begins with the JAX package's),
and a reference that loads nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

from kvbench import harness
from kvbench.conftest import SEED, TINY

CHECKOUT = Path(__file__).resolve().parent.parent


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("foundationdb_tpu_torch", "foundationdb_tpu_torch.ops",
                 "jax_like", "jaxlibs"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    for name in ("foundationdb_tpu", "foundationdb_tpu.ops.conflict", "jax",
                 "jaxlib.xla_client", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == sorted(
        ["foundationdb_tpu", "foundationdb_tpu.ops.conflict", "jax",
         "jaxlib.xla_client", "flax"])


def test_the_reference_and_the_generator_load_nothing_of_the_program():
    tops = json.loads(_python(
        "import sys, json; import kvbench.reference, kvbench.gen; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"))
    for name in ("foundationdb_tpu_torch", "foundationdb_tpu", "jax",
                 "jaxlib", "torch"):
        assert name not in tops


def test_a_run_loads_the_port_and_not_jax():
    code = (
        "import sys, json; from kvbench import harness; "
        f"r = harness.run_cell(harness.load_benchmark(), 'ycsb-1m.a-1k', "
        f"{SEED}, 0.3, False, device='cpu', "
        f"overrides={TINY['ycsb-1m.a-1k']!r}); "
        "print(json.dumps({'bad': harness.forbidden_modules(), 'tops': "
        "sorted({m.split('.')[0] for m in sys.modules}), "
        "'correct': r['correct']}))")
    got = json.loads(_python(code))
    assert got["correct"]
    assert got["bad"] == []
    assert "foundationdb_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "foundationdb_tpu"} & \
        set(got["tops"])
