"""Backup/restore subsystem.

Reference: fdbclient/FileBackupAgent.actor.cpp (continuous backup: range
snapshots + mutation-log tail into a container), fdbclient/TaskBucket.actor.cpp
(the fault-tolerant task queue stored in the database that drives it),
fdbserver/Restore.actor.cpp, and the proxy's mutation-log tee
(MasterProxyServer.actor.cpp:664-776 writing into \\xff/blog/).
"""

from foundationdb_tpu_torch.backup.agent import (
    BackupAgent, RestoreAgent, backup_keys)
from foundationdb_tpu_torch.backup.container import BackupContainer
from foundationdb_tpu_torch.backup.taskbucket import TaskBucket

__all__ = ["BackupAgent", "RestoreAgent", "BackupContainer", "TaskBucket",
           "backup_keys"]
