"""flowlint: the repo's own static analyzer for actor discipline.

See docs/flowlint.md. Public surface:

    from foundationdb_tpu_torch.analysis import flowlint
    findings = flowlint.analyze_paths(["foundationdb_tpu_torch/"])

or the CLI: `python -m foundationdb_tpu_torch.analysis --format=json`.
"""

from foundationdb_tpu_torch.analysis.flowlint import (  # noqa: F401
    Finding, analyze_paths, analyze_source, apply_baseline, load_baseline,
    write_baseline)
