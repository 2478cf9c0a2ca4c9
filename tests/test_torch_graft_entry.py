"""The port's graft entry points against `__graft_entry__.py`.

`graft_entry.entry(device="cpu")` builds the reference's example (K=1,024,
T=256, 256 reads and 256 writes, `np.random.RandomState(0)`, commit
version 200) through the port's encoder and step on the plain phases: its
batch is the JAX `entry()`'s with the key limbs' sign bit flipped, and one
step gives the JAX step's state, statuses and `info` exactly (state limbs
compared as tests/test_torch_conflict_ref.py compares them, through
`state_to_numpy`). `dryrun_multichip(n, device="cpu")` runs the
reference's two-step check over n shards that share the CPU; CUDA shards
on a machine without a card raise platform_error.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch import graft_entry
from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops.batch import COMMITTED
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

INFO_FIELDS = ("overflow", "boundaries", "committed", "converged",
               "eligible")


@pytest.fixture(autouse=True)
def _reset_port_knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


def test_entry_step_equals_the_jax_entry_step():
    import jax

    import __graft_entry__ as jg

    jfn, (jstate, jbatch) = jg.entry()
    fn, (state, batch) = graft_entry.entry(device="cpu")
    assert fn.keywords["phases"] is ref.PLAIN
    want_batch = ref.batch_from_numpy(
        {k: np.asarray(v) for k, v in jbatch.items()}, torch.device("cpu"))
    for k, v in want_batch.items():
        assert torch.equal(batch[k].reshape(v.shape), v), k
    before = {k: v.clone() for k, v in state.items()}

    jstate2, jst, jinfo = jax.jit(jfn)(jstate, jbatch)
    state2, st, info = fn(state, batch)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    for k in INFO_FIELDS:
        np.testing.assert_array_equal(info[k].numpy(), np.asarray(jinfo[k]),
                                      err_msg=k)
    got = ref.state_to_numpy(state2)
    for k in ("bkeys", "bval", "nb", "oldest", "table", "poisoned"):
        np.testing.assert_array_equal(got[k], np.asarray(jstate2[k]),
                                      err_msg=k)
    assert (st.numpy() == COMMITTED).all()  # from an empty state
    assert got["nb"] > 1  # the committed writes entered the state
    for k, v in before.items():  # fn leaves its inputs as they were
        assert torch.equal(state[k], v), k


def test_entry_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(FDBError) as ei:
        graft_entry.entry()
    assert ei.value.name == "platform_error"


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_multichip_on_shards_sharing_the_cpu(n):
    out = graft_entry.dryrun_multichip(n, device="cpu")
    assert out["shards"] == n and out["devices"] == ["cpu"] * n
    assert out["first"][0] == COMMITTED and out["second"][0] != COMMITTED


def test_dryrun_multichip_asks_cuda_for_its_shards():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for device in ("cuda", None):
        with pytest.raises(FDBError) as ei:
            graft_entry.dryrun_multichip(2, device=device)
        assert ei.value.name == "platform_error"
