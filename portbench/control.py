"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 101 102 ... [--out FILE]

For each seed it makes the cell's inputs, runs the program over every
distinct tile once (the cell's own requests, at the cell's sizes) and
holds each tile against the plain reference: the program's numbers, whose
largest over the seeds is a limit's lower reading.  Then it puts the
control in the program's place, the reference computed one precision
lower (bfloat16 coordinates for the float32 the configuration states),
and holds it against the reference the same way: the control's numbers,
whose smallest is the upper reading.  One JSON line a seed; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check as checking  # noqa: E402
from portbench import harness  # noqa: E402
from portbench.drive import make_entry  # noqa: E402


def readings(workload: str, seed: int, device: str = "cuda", info: dict | None = None,
             workdir: str | None = None) -> dict:
    """The program's and the control's worst numbers over the cell's
    distinct tiles for one seed."""
    info = info or harness.resolve(workload)
    workdir = workdir or os.path.join(tempfile.gettempdir(), f"portbench-control-{workload}")
    entry = make_entry(info["config"], info["traffic"], seed, device, workdir)
    try:
        entry.prepare()
        outputs = {}
        with entry.window():
            while len(outputs) < entry.config["distinct_tiles"]:
                req = entry.request(len(outputs))
                for t, out in zip(req.tiles, req.outputs):
                    outputs.setdefault(t, out)
        ref_mod = harness.reference_for(entry)
        prog, ctrl = [], []
        for t, out in sorted(outputs.items()):
            inputs = entry.reference_input(t)
            ref = checking.from_reference(ref_mod.run(inputs, entry.config))
            prog.append(checking.compare(entry.form(out), ref))
            low = checking.from_reference(ref_mod.run(inputs, entry.config, lower="bfloat16"))
            ctrl.append(checking.compare(low, ref))
        limits = entry.config["check"]
        return dict(workload=workload, seed=seed,
                    program=checking.judge(prog, limits), control=checking.judge(ctrl, limits))
    finally:
        entry.cleanup()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    harness.use_checkout_caches()
    try:
        harness.require_cards(harness.resolve(args.workload)["cell"]["chips"])
    except harness.Unavailable as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    lines = []
    for seed in args.seeds:
        line = json.dumps(readings(args.workload, seed))
        print(line, flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
