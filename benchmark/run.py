"""Run one cell of BENCHMARK.json once on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout (`python3 -m benchmark.run ...` does the
same).  Prints the set-up split and the compared numbers on standard
error, and as the last line of standard output one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `checks`, each compared number beside its limit.  Exits non-zero
and prints no result where no card (or too few) is visible, where the
port is not in the checkout, or where JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = "obj2voxel_tpu_torch"


def _fail(code: int, text: str):
    print(f"benchmark: {text}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    here = str(ROOT / "benchmark")
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if p not in (str(ROOT), here)]
    # found, not imported: the port reads some knobs at import
    found = importlib.util.find_spec(PORT)
    if found is None or Path(found.origin).resolve().parent != ROOT / PORT:
        _fail(3, f"no {PORT} in the checkout {ROOT}"
                 + (f" (found {found.origin})" if found is not None else ""))

    from benchmark.harness import cell, spec

    try:
        chips = spec.resolve(ROOT, args.workload).chips
    except (KeyError, FileNotFoundError, ValueError) as e:
        _fail(2, str(e))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _fail(2, f"{args.workload} needs {chips} CUDA card(s); "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
    result = cell.run_cell(ROOT, args.workload, args.seed & (2**64 - 1), args.seconds,
                           bool(args.trace), "cuda", T_PROCESS)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
