"""The port's probe kernels (ops/probes.py) against the Pallas kernel bodies.

scripts/ab_pallas.py and scripts/ab_pallas2.py run their probes when they
are imported, so the six kernel functions are lifted out of their source
with `ast` and executed alone, with small TILE/QT/LK, through
`pl.pallas_call(..., interpret=True)` on the CPU with the scripts' grids
and BlockSpecs. Each probe's plain version, and its wrapper on the CPU
(which runs the plain version), must equal the Pallas output exactly.

Two departures from the scripts, both forced by the kernel bodies:
  * join_kernel indexes its query block as (QT, L) and stores a (QT,) row,
    but ab_pallas.py gives it a (1, QT, L) query block, which does not
    broadcast against the state tile, and a (1, QT) output block, which
    refuses the (QT,) store (jax raises at trace time for both); the test
    squeezes both blocks' leading axis (`None`), the shapes the body
    indexes.
  * dynwrite_kernel writes 8 of its 64 output rows and leaves the rest
    unwritten (interpret mode fills them with the dtype's minimum); the
    port defines them as zero, so only the written rows are compared.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from foundationdb_tpu_torch.ops import kernels, probes
from foundationdb_tpu_torch.utils.errors import FDBError

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
# small shapes: K state rows in tiles of TILE, QT queries a tile, 2 passes
K, L, TILE, QT, LK, REP = 64, 8, 16, 8, 5, 2
NT = K // TILE


def lift(script: str, name: str, **consts):
    """The function `name` of scripts/<script>, compiled alone with jnp, pl
    and `consts` as its globals."""
    path = os.path.join(SCRIPTS, script)
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == name)
    ns = {"jnp": jnp, "pl": pl, **consts}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns[name]


def t32(a):
    """numpy (u)int32 -> torch int32 of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def both(name, *args, **kw):
    """(plain version, wrapper on the CPU) outputs, as numpy."""
    kernels.reset_launches()
    out = (probes.PLAIN[name](*args, **kw).numpy(),
           probes.WRAPPERS[name](*args, **kw).numpy())
    assert kernels.LAUNCHES[name] == 0
    return out


def test_add():
    x = np.arange(1024, dtype=np.int32).reshape(8, 128)
    want = pl.pallas_call(
        lift("ab_pallas.py", "add_kernel"),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        interpret=True)(jnp.asarray(x))
    for got in both("probe_add", t32(x)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_stream_rows_uint32():
    rng = np.random.RandomState(1)
    state = rng.randint(0, 1 << 32, size=(K, L), dtype=np.uint64).astype(
        np.uint32)
    state[:, 3] = rng.randint(0, 5, size=K)  # a limb far below 2^31
    want = pl.pallas_call(
        lift("ab_pallas.py", "stream_kernel"), grid=(K // TILE,),
        in_specs=[pl.BlockSpec((TILE, L), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((1, L), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, L), jnp.uint32),
        interpret=True)(jnp.asarray(state))
    for got in both("probe_stream_rows", t32(state), layout="rows",
                    unsigned=True):
        np.testing.assert_array_equal(got.view(np.uint32), np.asarray(want))
    assert np.asarray(want).max() >= 1 << 31  # the unsigned order mattered


def test_join_uint32():
    rng = np.random.RandomState(2)
    state = rng.randint(0, 1 << 32, size=(K, L), dtype=np.uint64).astype(
        np.uint32)
    queries = rng.randint(0, 1 << 32, size=(NT, QT, L),
                          dtype=np.uint64).astype(np.uint32)
    queries[0, :2, 0] = state[:2, 0]  # ties: equal is not below
    want = pl.pallas_call(
        lift("ab_pallas.py", "join_kernel"), grid=(K // TILE,),
        in_specs=[pl.BlockSpec((TILE, L), lambda i: (i, 0)),
                  pl.BlockSpec((None, QT, L), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((None, QT), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((K // TILE, QT), jnp.int32),
        interpret=True)(jnp.asarray(state), jnp.asarray(queries))
    for got in both("probe_join", t32(state), t32(queries), unsigned=True):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("off", [16, 0, 56])
def test_dynwrite(off):
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128) + 1
    want = np.asarray(pl.pallas_call(
        lift("ab_pallas.py", "dynwrite_kernel"),
        in_specs=[pl.BlockSpec((1,), lambda: (0,)),
                  pl.BlockSpec((8, 128), lambda: (0, 0))],
        out_specs=pl.BlockSpec((64, 128), lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((64, 128), jnp.int32),
        interpret=True)(jnp.asarray([off], jnp.int32), jnp.asarray(x)))
    for got in both("probe_dynwrite", t32(np.array([off], np.int32)), t32(x),
                    rows=64):
        np.testing.assert_array_equal(got[off:off + 8], want[off:off + 8])
        assert not np.delete(got, np.s_[off:off + 8], axis=0).any()


def test_stream_limbs_int32():
    rng = np.random.RandomState(3)
    state = rng.randint(-(1 << 31), 1 << 31, size=(L, K)).astype(np.int32)
    state[2] = -rng.randint(1, 9, size=K)  # an all-negative limb: max is 0
    want = pl.pallas_call(
        lift("ab_pallas2.py", "stream_kernel"), grid=(REP, NT),
        in_specs=[pl.BlockSpec((L, TILE), lambda r, i: (0, i))],
        out_specs=pl.BlockSpec((L, 1), lambda r, i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((L, 1), jnp.int32),
        interpret=True)(jnp.asarray(state))
    for got in both("probe_stream_limbs", t32(state), layout="limbs"):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert int(np.asarray(want)[2, 0]) == 0


def test_lexjoin_int32():
    rng = np.random.RandomState(4)
    # limb values in [0, 3): the first limbs tie often, so later limbs and
    # full-key ties decide ranks
    state = rng.randint(0, 3, size=(L, K)).astype(np.int32)
    queries = rng.randint(0, 3, size=(NT, L, QT)).astype(np.int32)
    state[:, 5] = -7  # a negative limb value
    want = pl.pallas_call(
        lift("ab_pallas2.py", "lexjoin_kernel", QT=QT, TILE=TILE, LK=LK),
        grid=(REP, NT),
        in_specs=[pl.BlockSpec((L, TILE), lambda r, i: (0, i)),
                  pl.BlockSpec((1, L, QT), lambda r, i: (i, 0, 0))],
        out_specs=pl.BlockSpec((QT,), lambda r, i: (i,)),
        out_shape=jax.ShapeDtypeStruct((NT * QT,), jnp.int32),
        interpret=True)(jnp.asarray(state), jnp.asarray(queries))
    for got in both("probe_lexjoin", t32(state), t32(queries), limbs=LK):
        np.testing.assert_array_equal(got, np.asarray(want))
    # and the searchsorted check of ab_pallas2.py:89-105 agrees
    probes.lexjoin_searchsorted_check(t32(state), t32(queries),
                                      torch.from_numpy(np.array(want)))


def test_script_calls_have_the_scripts_shapes():
    calls = probes.script_calls("meta")
    (s1,), kw = calls["probe_stream_rows"]
    assert tuple(s1.shape) == (1 << 18, 8) and kw["unsigned"]
    (s2, q2), kw = calls["probe_lexjoin"]
    assert tuple(q2.shape) == (128, 8, 1024) and kw["limbs"] == 5
    (_, q1), _ = calls["probe_join"]
    assert tuple(q1.shape) == (128, 256, 8)


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FDBError) as ei:
        probes.main()
    assert ei.value.name == "platform_error"
