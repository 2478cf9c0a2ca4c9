"""Backup/restore subsystem: this slice has the backup key schema only
(agent.py), which the proxy's mutation-log tee reads. The BackupAgent,
RestoreAgent, TaskBucket and BackupContainer are not ported yet."""
