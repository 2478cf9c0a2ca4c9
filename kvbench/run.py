"""One run of one cell of BENCHMARK.json, on the card:

    python3 -m kvbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It prints the run's log on standard error,
ending with each compared number beside its limit, and one JSON object as
the last line of standard output. It exits 1, printing no result, when
there is no card (or fewer than the cell asks for) or when a module of
JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def power_limit_w(index: int):
    """The card's power limit in watts, as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kvbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    t_torch = time.perf_counter()
    from kvbench import harness
    t_port = time.perf_counter()
    torch.set_num_threads(1)  # the host work is one thread's
    bench = harness.load_benchmark()
    chips = harness.cell(bench, args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kvbench: {args.workload} needs {chips} CUDA device(s); "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    harness.log(f"import torch {t_torch - T_START:.3f} s, the port "
                f"{t_port - t_torch:.3f} s, the card "
                f"{time.perf_counter() - t_port:.3f} s")
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"kvbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 1
    limit = power_limit_w(torch.cuda.current_device())
    harness.log(f"{result['device']['kind']}, power limit {limit} W")
    checks = result.pop("checks")
    result["power_limit_w"] = limit
    result["checks"] = checks
    line = harness.json_line(result)
    for text in harness.check_lines(result):
        print(text, file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
