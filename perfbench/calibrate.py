"""Readings that the limits of ``limits/<cell>.json`` are set from: runs of
one cell in one process, each on its own seed, each with the float8
control read beside the program.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s>
        --seeds 11 12 13 ... [--control-seeds N] [--fault NAME] [--out FILE]

Prints one JSON line a seed: the program's and (on the first
``--control-seeds`` seeds, all by default) the control's readings
(``check.summary``), the metrics and the set-up seconds; with ``--out``
it appends the same lines to FILE.  With ``--fault`` the program runs
with that fault of ``faults.py`` planted, at the cell's own size.  The
benchmark's own runs read neither.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first N seeds only")
    ap.add_argument("--fault", default=None,
                    help="plant this fault of faults.py in the program")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.faults import FAULTS
    if not torch.cuda.is_available():
        print("[calibrate] no CUDA device", file=sys.stderr)
        return 2
    t0 = T0
    n_control = len(args.seeds) if args.control_seeds is None \
        else args.control_seeds
    for i, seed in enumerate(args.seeds):
        res = harness.run_cell(args.workload, seed, args.seconds,
                               bool(args.trace), device="cuda", t0=t0,
                               control=i < n_control,
                               patch=FAULTS[args.fault] if args.fault
                               else None)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "fault": args.fault, **res})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
