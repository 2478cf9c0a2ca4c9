"""kvbench: the benchmark of foundationdb_tpu_torch's resolver engine on
the card. `python3 -m kvbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>` runs one cell once (kvbench/run.py)."""
