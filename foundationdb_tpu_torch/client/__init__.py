"""Client layer: Transaction/Database API with read-your-writes.

Reference layer 2 (fdbclient/): NativeAPI.actor.cpp Transaction +
ReadYourWrites.actor.cpp overlay, collapsed into one Transaction class —
the RYW overlay (WriteMap) is not optional here, matching how every real
binding uses the reference (ReadYourWrites.h:64).
"""

from foundationdb_tpu_torch.client.database import Database
from foundationdb_tpu_torch.client.transaction import Transaction

__all__ = ["Database", "Transaction"]
