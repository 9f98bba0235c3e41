"""Time K1 against a parent checkout's K1 on one card, in turns.

    python3 scripts/ab_k1.py --parent DIR [--out FILE]

DIR is a parent checkout unpacked with `git archive` (its
`obj2voxel_tpu_torch/` is enough): its package is imported under another
name and builds its own kernels.  On bench.py's 2M-triangle sphere at 1024^3
(the table of chip_smoke.py phase 7, and phase 12's textured one), each side
runs, per case:
- `passes`: every pass of the sphere's schedule, one `fused_pass` call
  each, as the default path dispatches them (the time is per pass);
- `pass`: phase 2's pass alone (2^21 slots at expand 8);
- `batch8`: the sphere's first batched launch of 8 passes (untextured).
Both sides' counts and live rows are held equal, bit for bit, before the
timing; then each case is timed by CUDA events (chip_smoke.cuda_ms, 10
calls after a warm-up) in the turns this, parent, parent, this, twice.
Prints the card's name and power limit and one JSON line; with --out,
writes it there too.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from obj2voxel_tpu_torch.engine import _schedule_passes  # noqa: E402
from obj2voxel_tpu_torch.ops import pass_fused  # noqa: E402
from obj2voxel_tpu_torch.ops.plan_device import gather_ordered, plan_mesh_device  # noqa: E402


def import_parent(parent):
    pkg = Path(parent).resolve() / "obj2voxel_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_pt", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_pt"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_pt.ops.pass_fused")


def schedule(textured):
    """The sphere table and its AABBs, and every pass of its schedule as
    (args, kwargs) of `fused_pass` on the plan-ordered table."""
    table_np, aabb = cs.sphere_table(cs.SPHERE_TRIS, cs.SPHERE_RES, textured)
    table = torch.from_numpy(table_np).cuda()
    order, segs = plan_mesh_device(table, aabb[0].shape[0], cs.SPHERE_RES,
                                   cs.SPHERE_RES, 4 * cs.BUDGET, group=8)
    ordered = gather_ordered(table, order, segs[-1].r1, 8)
    slabs = {}
    for seg in segs:
        slabs.setdefault((seg.z_lo, seg.z_hi), []).append(seg)
    calls = []
    for (z_lo, z_hi), ss in slabs.items():
        for expand, budget, r0, n_rows, local_base, wide in _schedule_passes(ss, cs.BUDGET):
            calls.append(((ordered, r0, n_rows, local_base, z_lo, z_hi, cs.SPHERE_RES),
                          dict(expand=expand, budget=budget, wide_local=wide,
                               textured=textured)))
    return table, aabb, calls


def same_live(got, want, what):
    """Counts equal, then each row's live prefix bit for bit."""
    counts = want[5].reshape(-1).tolist()
    if got[5].reshape(-1).tolist() != counts:
        raise SystemExit(f"{what}: counts differ")
    for g, w in zip(got[:5], want[:5]):
        g, w = g.reshape(len(counts), -1), w.reshape(len(counts), -1)
        for b, n in enumerate(counts):
            if not torch.equal(g[b, :n].view(torch.int32), w[b, :n].view(torch.int32)):
                raise SystemExit(f"{what}: live rows differ")
    return sum(counts)


def turns(this, parent):
    """CUDA-event ms of both sides in the turns this, parent, parent, this,
    twice."""
    runs = {"this": [], "parent": []}
    for side in ("this", "parent", "parent", "this") * 2:
        runs[side].append(cs.cuda_ms(this if side == "this" else parent))
    return {"this_ms": sum(runs["this"]) / 4, "parent_ms": sum(runs["parent"]) / 4,
            "runs": runs}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    info = cs.gpu_info()
    print(f"[gpu] {info}", flush=True)
    parent = import_parent(args.parent)
    result = {"gpu": info}
    for textured in (False, True):
        table, aabb, calls = schedule(textured)
        ordered, r0, z_lo, z_hi = cs.sphere_pass(table, aabb, lambda n: n // 2)
        n_rows = min(cs.BUDGET // 8, ordered.shape[0] - r0)
        mid = ((ordered, r0, n_rows, 0, z_lo, z_hi, cs.SPHERE_RES),
               dict(expand=8, budget=cs.BUDGET, textured=textured))
        for a, kw in [*calls, mid]:
            same_live(pass_fused.fused_pass(*a, **kw), parent.fused_pass(*a, **kw),
                      f"pass {a[1:]}")
        cases = {
            "passes": (lambda: [pass_fused.fused_pass(*a, **kw) for a, kw in calls],
                       lambda: [parent.fused_pass(*a, **kw) for a, kw in calls]),
            "pass": (lambda: pass_fused.fused_pass(*mid[0], **mid[1]),
                     lambda: parent.fused_pass(*mid[0], **mid[1])),
        }
        if not textured:
            ordered, batches = cs.sphere_batches(table, aabb)
            expand, budget, passes, _ = batches[0]
            bkw = dict(expand=expand, budget=budget)
            same_live(pass_fused.fused_pass_batch(ordered, passes, **bkw),
                      parent.fused_pass_batch(ordered, passes, **bkw), "batch of 8")
            cases["batch8"] = (lambda: pass_fused.fused_pass_batch(ordered, passes, **bkw),
                               lambda: parent.fused_pass_batch(ordered, passes, **bkw))
        tag = "textured" if textured else "untextured"
        for name, (this, par) in cases.items():
            r = turns(this, par)
            if name == "passes":
                r = {**r, "n_passes": len(calls),
                     "this_ms_per_pass": r["this_ms"] / len(calls),
                     "parent_ms_per_pass": r["parent_ms"] / len(calls)}
            r["ratio"] = r["this_ms"] / r["parent_ms"]
            result[f"{tag}_{name}"] = r
            print(f"[ab] {tag} {name}: this {r['this_ms']:.4f} ms, parent "
                  f"{r['parent_ms']:.4f} ms ({r['ratio']:.4f}x)", flush=True)
        del table, ordered, calls, mid, cases
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
