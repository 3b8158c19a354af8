#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on one CUDA card.

    python3 encbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control]

Prints progress and, as its last lines, each compared number beside its
limit on standard error; the result as one JSON object on the last line of
standard output. Without a CUDA card, or with fewer than the cell asks for,
it exits with code 2 and prints no result. ``--control`` runs the
check's control: the reconstruction one bit below the configuration's
precision compared in the program's place, which must come out not correct;
the benchmark's own runs do not ask for it.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout
_CACHE = ROOT / "build" / "encbench"
for _var, _sub in (("CUDA_CACHE_PATH", "cuda"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(_CACHE / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    from encbench import harness

    spec = harness.load_spec(args.workload, bool(args.trace))
    import torch

    chips = spec.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA card(s); "
                    f"{torch.cuda.device_count()} visible: no result")
        return 2
    result, lines = harness.run_cell(spec, args.seed, args.seconds,
                                     bool(args.trace), T_START,
                                     control=args.control)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"the run loaded {found}, which it may not: no result")
        return 3
    for line in lines:
        harness.log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
