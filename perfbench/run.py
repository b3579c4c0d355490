"""Run one cell of ``BENCHMARK.json`` once on the card and print its
result as the last line of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

It measures only the port (``repro_torch`` under ``src/``) and exits
non-zero without a result when no card is there, when the cell asks for
more cards than there are, when the port is missing, or when the run has
loaded JAX or the JAX package (``harness.FORBIDDEN``).
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness, registry
    chips = registry.workload(args.workload)["chips"]
    if not torch.cuda.is_available():
        print("[perfbench] no CUDA device: nothing is measured",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"[perfbench] {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"[perfbench] the run loaded {found}: neither the harness nor "
              f"the port may import them", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
