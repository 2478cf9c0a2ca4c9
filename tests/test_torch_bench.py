"""The port's kernel bench (foundationdb_tpu_torch/bench.py) against the
repository's bench.py and the JAX `conflict_scan`, on the CPU.

The root bench.py is loaded from its file with importlib (importing it runs
nothing). Its batch encoder and the port's must give the same batches, up
to the port's signed key limbs. The port's timed core, run on the CPU at
T=64, 4 batches in chunks of 2 and K=2^12, must give the same per-batch
committed counts and statuses as the jitted JAX `conflict_scan` on the same
batches. And the bench has no CPU fallback: at its default device it raises
where there is no CUDA.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu_torch import bench
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.utils import keys as keylib
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

CPU = torch.device("cpu")
T, N_BATCHES, CHUNK, K = 64, 4, 2, 1 << 12
LIMB_FIELDS = ("rb", "re", "wb", "we")


@pytest.fixture(autouse=True)
def _reset_port_knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


@pytest.fixture
def root_bench(monkeypatch):
    path = os.path.join(os.path.dirname(__file__), "..", "bench.py")
    spec = importlib.util.spec_from_file_location("root_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "TXNS_PER_BATCH", T)  # its encoder reads it
    return mod


def test_encoder_equals_the_root_bench(root_bench):
    for name in ("KEYSPACE", "MAX_SPAN", "CAPACITY", "KEY_BYTES", "WINDOW",
                 "VERSION_STEP", "N_BATCHES", "CHUNK",
                 "BASELINE_FLOOR_TXNS_PER_SEC"):
        assert getattr(bench, name) == getattr(root_bench, name), name
    for seed, v0 in ((1, bench.WINDOW), (2, bench.WINDOW + 7 * 625_000)):
        want = root_bench._encode_batches(3, seed=seed, version0=v0)
        got = bench._encode_batches(3, seed=seed, version0=v0, T=T)
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            if k in LIMB_FIELDS:
                g = keylib.from_signed_limbs(g)
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_timed_core_equals_the_jax_scan(root_bench):
    warm_np = bench._encode_batches(CHUNK, seed=1, version0=bench.WINDOW, T=T)
    main_np = bench._encode_batches(
        N_BATCHES, seed=2, version0=bench.WINDOW + CHUNK * bench.VERSION_STEP,
        T=T)
    chunks_np = [{k: v[c:c + CHUNK] for k, v in main_np.items()}
                 for c in range(0, N_BATCHES, CHUNK)]
    res = bench.timed_scan(
        ref.init_state(K, bench.LIMBS, CPU), bench.stage(warm_np, CPU),
        [bench.stage(c, CPU) for c in chunks_np], phases=ref.PLAIN)

    shapes = jconf.ConflictShapes(capacity=K, txns=T, reads=T, writes=T,
                                  key_bytes=bench.KEY_BYTES, strided=True)
    scan = jconf._compiled_scan(shapes, bench.WINDOW)

    def to_jax(b):
        return {k: keylib.from_signed_limbs(v) if k in LIMB_FIELDS else v
                for k, v in b.items()}
    state, warm_st, _c, _o = scan(jconf.init_state(shapes), to_jax(warm_np))
    np.testing.assert_array_equal(res["warm_statuses"].numpy(),
                                  np.asarray(warm_st))
    committed = []
    for i, ch in enumerate(chunks_np):
        state, st, comm, ovf = scan(state, to_jax(ch))
        np.testing.assert_array_equal(res["statuses"][i].numpy(),
                                      np.asarray(st), err_msg=f"chunk {i}")
        committed.append(np.asarray(comm))
        assert not np.asarray(ovf).any()
    np.testing.assert_array_equal(res["committed"], np.concatenate(committed))
    assert not res["overflow"].any() and not res["warm_overflow"].any()
    assert res["committed"].sum() > 0
    assert res["seconds"] > 0


def test_bench_has_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bench.run_kernel(T, N_BATCHES, CHUNK, capacity=K),
                 lambda: bench.run_kernel_ab(T, 2, capacity=K)):
        with pytest.raises(FDBError) as ei:
            call()
        assert ei.value.name == "platform_error"


def test_ab_on_the_cpu_gives_equal_statuses():
    out = bench.run_kernel_ab(T, 3, capacity=K, device="cpu")
    assert out["statuses_equal"]
    assert out["scan_ms_per_step"] > 0 and out["legacy_ms_per_step"] > 0


def test_missing_compiler_is_reported_not_raised(monkeypatch):
    monkeypatch.setenv("CC", "false")
    out = bench.measure_cpu_baseline(T)
    assert set(out) == {"error"}
