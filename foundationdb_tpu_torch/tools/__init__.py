"""Operator tools: fdbbackup (backup CLI) and fdbcli (the shell)."""
