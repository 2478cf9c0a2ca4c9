"""Operator tools: fdbbackup (backup CLI), fdbcli (the shell), fdbmonitor
(the process supervisor), networktest (the wire's throughput and latency)
and trace_analyze (per-stage commit latency from trace files)."""
