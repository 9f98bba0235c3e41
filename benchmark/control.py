"""The control of a cell's comparison: the plain reference put in the
port's place and computed one precision below the configuration's float32
(bfloat16), held against the float32 reference by the cell's own
comparison, on each seed given, on the card.  It has to come out as not
correct.  The benchmark's own runs do not run it.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

Prints one JSON line a seed: the seed, the compared numbers with their
limits, whether the control passed them (it must not), and the seconds of
each reference.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_readings(root, workload: str, seed: int, device="cuda") -> dict:
    """The control's compared numbers on one seed."""
    import torch

    from benchmark.harness import checks, inputs, spec
    from benchmark.harness.adapter import Conversion

    cell = spec.resolve(root, workload)
    entry = cell.entry(cell.config, inputs.make(cell, seed, device), device)
    t = time.perf_counter()
    reference = entry.reference(torch.float32, device)
    t_ref = time.perf_counter() - t
    t = time.perf_counter()
    low = entry.reference(torch.bfloat16, device)
    t_low = time.perf_counter() - t
    # the low-precision reference's outputs stand where the port's would
    conv = Conversion(work={}, units=low)
    judged, _, _ = checks.judge([conv], lambda unit: unit[:2], reference,
                                int(cell.config["guarantees"]["color_lsb"]))
    return {"workload": workload, "seed": seed,
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in judged.items()},
            "passed": checks.passed(judged),
            "reference_s": t_ref, "control_s": t_low}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_readings(ROOT, args.workload, seed)), flush=True)


if __name__ == "__main__":
    main()
