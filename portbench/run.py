"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  It makes its inputs from the seed under TMPDIR, warms up on the
cell's shapes, measures for --seconds, checks every tile the window
returned against the plain reference, and prints one JSON object as the
last line of standard output (the numbers compared, each beside its limit,
come last there and as the last lines of standard error).  It exits 2,
printing no result, without a CUDA card or with fewer cards than the cell
asks for, and 3 if a module of JAX or of the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def process_age_s() -> float:
    """Seconds since this process started (from /proc), so set-up counts
    the interpreter's own start; 0 where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    t_start = T_START - process_age_s() + (time.perf_counter() - T_START)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness

    harness.use_checkout_caches()
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_start=t_start)
    except harness.Unavailable as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
