"""The conflict engine: plain PyTorch step, Hopper kernels, host oracle."""

from foundationdb_tpu_torch.ops.batch import (  # noqa: F401
    COMMITTED,
    CONFLICT,
    TOO_OLD,
    TxnConflictInfo,
)
