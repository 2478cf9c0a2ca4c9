"""CLI: `python -m foundationdb_tpu_torch.analysis [paths...]`.

Exit codes: 0 = clean (every finding baselined), 1 = new violations or
baseline drift under --check, 2 = usage error. `--update-baseline`
regenerates the allowlist, carrying forward documented reasons and
stamping FIXME on new entries so an undocumented grandfather can never
slip through tier-1. `--update-baseline --check` performs a dry run: it
compares the would-be baseline against the committed one and fails on any
difference (the drift gate tests/test_torch_analysis.py runs).
"""

from __future__ import annotations

import argparse
import json
import sys

from foundationdb_tpu_torch.analysis import flowlint


def _family_set(family: str) -> set[str] | None:
    return None if family == "all" else {family}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m foundationdb_tpu_torch.analysis",
        description="flowlint/devlint/protolint/natlint: actor-discipline, "
                    "determinism, device-discipline, protocol-conformance "
                    "and native-C analyzer")
    parser.add_argument("paths", nargs="*",
                        help="files/directories to analyze (default: the "
                             "foundationdb_tpu_torch package)")
    parser.add_argument("--family",
                        choices=flowlint.FAMILIES + ("all",),
                        default="all",
                        help="rule family to run (default: all)")
    parser.add_argument("--format", choices=("text", "json", "github"),
                        default="text")
    parser.add_argument("--baseline", default=flowlint.default_baseline_path(),
                        help="baseline allowlist path (default: the "
                             "checked-in flowlint_baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, baselined or not")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from current findings")
    parser.add_argument("--check", action="store_true",
                        help="with --update-baseline: don't write; exit 1 "
                             "if the regenerated baseline would differ "
                             "from the committed one (drift detection)")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    rules = flowlint.active_rules(args.family)
    families = _family_set(args.family)
    if args.list_rules:
        for r in rules:
            print(f"{r.code}  {r.summary}")
        return 0
    if args.check and not args.update_baseline:
        parser.error("--check requires --update-baseline")

    paths = args.paths or flowlint.default_targets()
    findings = flowlint.analyze_paths(paths, rules)

    if args.update_baseline:
        old = flowlint.load_baseline(args.baseline)
        if args.check:
            import os
            import tempfile
            fd, tmp = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                flowlint.write_baseline(tmp, findings, old,
                                        families=families)
                with open(tmp, encoding="utf-8") as f:
                    regenerated = json.load(f)
            finally:
                os.unlink(tmp)
            committed = {"version": 1,
                         "entries": sorted(
                             old.entries,
                             key=lambda e: (e["rule"], e["path"],
                                            e["symbol"], e["detail"]))}
            if regenerated != committed:
                print("baseline drift: the committed baseline no longer "
                      "matches current findings (run --update-baseline "
                      "and document any new entries)", file=sys.stderr)
                return 1
            print("baseline up to date", file=sys.stderr)
            return 0
        flowlint.write_baseline(args.baseline, findings, old,
                                families=families)
        print(f"baseline written: {args.baseline} "
              f"({len(findings)} finding(s))", file=sys.stderr)
        return 0

    if args.no_baseline:
        new, stale = findings, []
    else:
        baseline = flowlint.load_baseline(args.baseline)
        new, stale = flowlint.apply_baseline(findings, baseline,
                                             families=families)

    formatter = {"json": flowlint.format_json,
                 "github": flowlint.format_github,
                 "text": flowlint.format_text}[args.format]
    out = formatter(new)
    if out:
        print(out)
    for entry in stale:
        print(f"warning: stale baseline entry "
              f"{flowlint._entry_key(entry)} matches nothing "
              f"(run --update-baseline)", file=sys.stderr)
    if new:
        print(f"flowlint: {len(new)} new violation(s) "
              f"({len(findings) - len(new)} baselined)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
