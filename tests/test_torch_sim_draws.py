"""The port's cluster draw against the JAX draw; no cluster is booted.

A seed means the same cluster in both packages only if the port's
`ClusterDraw.draw` consumes the rng exactly as the reference's does: the
draw walks every knob that declares extremes, in sorted order, before it
draws the topology, so one knob too few or one extreme that differs would
shift every later draw. These tests hold the port's knob bank and draw to
the JAX ones over many seeds, field for field.
"""

import dataclasses

import pytest

from foundationdb_tpu.testing import simulated_cluster as j_sc
from foundationdb_tpu.utils.knobs import KNOBS as JKNOBS
from foundationdb_tpu.utils.rng import DeterministicRandom as JRandom
from foundationdb_tpu_torch.testing import simulated_cluster as t_sc
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS
from foundationdb_tpu_torch.utils.rng import DeterministicRandom as TRandom

ALLOW_LISTS = {"default": j_sc.DEFAULT_BACKENDS,
               "device-sharded": ("device", "sharded")}
SEED_BLOCKS = [range(b, b + 100) for b in range(0, 500, 100)]


@pytest.fixture(autouse=True)
def _knobs():
    TKNOBS.reset()
    TKNOBS.set("CONFLICT_DEVICE", "cpu")
    yield
    TKNOBS.reset()


@pytest.mark.parametrize("allow", list(ALLOW_LISTS))
@pytest.mark.parametrize("seeds", SEED_BLOCKS,
                         ids=[f"{s.start}-{s.stop - 1}" for s in SEED_BLOCKS])
def test_cluster_draw_equals_the_jax_draw(allow, seeds):
    backends = ALLOW_LISTS[allow]
    for seed in seeds:
        port = t_sc.ClusterDraw.draw(seed, allow_backends=backends)
        jax = j_sc.ClusterDraw.draw(seed, allow_backends=backends)
        assert dataclasses.astuple(port) == dataclasses.astuple(jax), seed
        assert port.summary() == jax.summary()
        assert port.repro_line("cycle", 25.0) == jax.repro_line(
            "cycle", 25.0).replace("foundationdb_tpu.",
                                   "foundationdb_tpu_torch.")


def test_draw_under_narrowed_allow_lists_equals_the_jax_draw():
    """Other allow-lists shift the later draws the same way on both sides."""
    for seed in range(100):
        for kw in (dict(allow_engines=("memory",)),
                   dict(allow_two_region=False),
                   dict(allow_backends=("oracle",), allow_engines=("ssd",
                                                                   "redwood"))):
            assert t_sc.ClusterDraw.draw(seed, **kw) == \
                t_sc.ClusterDraw(**dataclasses.asdict(
                    j_sc.ClusterDraw.draw(seed, **kw))), (seed, kw)


def test_draw_buggified_equals_the_jax_draw_on_forked_rngs():
    jroot, troot = JRandom(1234), TRandom(1234)
    drawn = set()
    for _ in range(200):
        jr, tr = jroot.fork(), troot.fork()
        port = TKNOBS.draw_buggified(tr)
        assert port == JKNOBS.draw_buggified(jr)
        assert tr.random() == jr.random()  # the rngs advanced alike
        drawn.update(port)
    assert len(drawn) > 40  # most knobs with extremes were drawn


def test_buggify_sets_the_drawn_knobs():
    rng = TRandom(9)
    want = TKNOBS.draw_buggified(TRandom(9))
    assert TKNOBS.buggify(rng) == want
    for k, v in want.items():
        assert getattr(TKNOBS, k) == v
    TKNOBS.reset()
    assert all(getattr(TKNOBS, k) == TKNOBS._defs[k].default for k in want)


def test_every_jax_knob_with_extremes_is_the_ports():
    """The same defaults and extremes for the 46 knobs the draw walks; the
    port's own knobs declare none."""
    jax = {k: (d.default, d.extremes) for k, d in JKNOBS._defs.items()
           if d.extremes}
    port = {k: (d.default, d.extremes) for k, d in TKNOBS._defs.items()
            if d.extremes}
    assert len(jax) == 46
    assert port == jax
    for k in ("CONFLICT_DEVICE", "COUNTERS_TRACE_INTERVAL"):
        assert k not in JKNOBS._defs and not TKNOBS._defs[k].extremes


def test_knobs_both_banks_declare_have_the_same_defaults():
    shared = set(TKNOBS._defs) & set(JKNOBS._defs)
    assert {"REDWOOD_BLOOM_HASHES", "REDWOOD_MEMTABLE_BYTES",
            "STORAGE_ENGINE"} <= shared
    for k in shared:
        assert TKNOBS._defs[k].default == JKNOBS._defs[k].default, k


@pytest.mark.parametrize("allow", list(ALLOW_LISTS))
def test_apply_knobs_leaves_equal_values_in_both_banks(allow):
    """The draw's knobs, engine, backend and sim shapes installed, seed by
    seed, on both banks: every knob both declare holds the same value.
    (The JAX side's sharded shape also sets CONFLICT_CPU_FALLBACK, which the
    port's does not: both banks start with it at "jax".)"""
    shared = sorted(set(TKNOBS._defs) & set(JKNOBS._defs))
    backends = ALLOW_LISTS[allow]
    for seed in range(200):
        TKNOBS.reset()
        TKNOBS.overrides(CONFLICT_DEVICE="cpu", CONFLICT_CPU_FALLBACK="jax")
        JKNOBS.reset()
        JKNOBS.set("CONFLICT_CPU_FALLBACK", "jax")
        draw = t_sc.ClusterDraw.draw(seed, allow_backends=backends)
        draw.apply_knobs()
        j_sc.ClusterDraw(**dataclasses.asdict(draw)).apply_knobs()
        for k in shared:
            assert getattr(TKNOBS, k) == getattr(JKNOBS, k), (seed, k)
    JKNOBS.reset()


def test_sharded_draws_keep_two_shards_on_the_cpu():
    draw = next(d for d in map(t_sc.ClusterDraw.draw, range(100))
                if d.conflict_backend == "sharded")
    draw.apply_knobs()
    assert TKNOBS.CONFLICT_NUM_SHARDS == 2
    assert TKNOBS.CONFLICT_BATCH_TXNS == 16
    assert TKNOBS.CONFLICT_STATE_CAPACITY == 2048
