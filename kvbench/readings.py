"""The readings that the limits of `correct` are set from, on the card:
a cell's sound runs over many seeds and its control over a few, in one
process (the benchmark's own runs never run the control).

    python3 -m kvbench.readings --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 3 [--out readings.jsonl]

The control is the program with its intra-batch check switched off
(`ablate="no_intra"`, a path of the port's own step): it breaks the
configuration's guarantee that earlier txns win inside a batch. Each run
prints one JSON line: the seed, the control's ablation or "", the compared
numbers, the counts and the end-to-end metrics.
"""

import argparse
import json
import sys

import torch

from kvbench import harness

CONTROL = "no_intra"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kvbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kvbench.readings: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    bench = harness.load_benchmark()
    runs = [(int(s), "") for s in args.seeds.split(",") if s] + \
        [(int(s), CONTROL) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, ablate in runs:
            r = harness.run_cell(bench, args.workload, seed, args.seconds,
                                 False, ablate=ablate)
            line = json.dumps({
                "workload": args.workload, "seed": seed, "ablate": ablate,
                "correct": r["correct"],
                "checks": {n: c["value"] for n, c in r["checks"].items()},
                "counts": r["counts"],
                "metrics": {n: m["value"] for n, m in r["metrics"].items()},
                "kind": r["device"]["kind"]})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
