"""Smoke test of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from obj2voxel_tpu_torch/csrc, holds
each against its plain PyTorch version on the card, drives the main path
(`stream_slabs` on the 2M-triangle sphere at 1024^3, BLEND, as bench.py
does) and checks the output against known voxel counts.

    python3 chip_smoke.py             # all phases; needs one CUDA device
    python3 chip_smoke.py --phases 1,2,3,4

Prints one line per phase, a JSON line with the kernels' errors and times,
and as its last line {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero before that line is printed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

SPHERE_TRIS = 2_000_000
SPHERE_RES = 1024
# The JAX package's count for the same table on the CPU, run op by op (no
# multiply-add contraction, like the port).  Grazing pairs at voxel faces
# fall either side of the clip's epsilon tests under other roundings: a TPU
# run recorded 4,936,253, and the jitted XLA CPU clip, which contracts
# multiply-adds into FMAs, gives 4,936,300.
SPHERE_VOXELS = 4_936_255
BUDGET = 1 << 21
STREAM = 1 << 22

KERNELS = {
    "fused_pass": ("obj2voxel_tpu_torch/csrc/fused_pass.cu",
                   "obj2voxel_tpu/ops/pass_fused.py:251"),
    "segment_combine": ("obj2voxel_tpu_torch/csrc/segment_combine.cu",
                        "obj2voxel_tpu/ops/combine_pallas.py:126"),
    "pack_exact": ("obj2voxel_tpu_torch/csrc/pack_exact.cu",
                   "obj2voxel_tpu/ops/pack_pallas.py:285"),
}


def fail(msg):
    raise RuntimeError(msg)


def phase(name, t0, detail):
    print(f"[phase] {name}: PASS ({time.perf_counter() - t0:.2f} s) {detail}",
          flush=True)


def gpu_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def cuda_ms(fn, reps=10):
    """Mean ms per call over `reps` calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sphere_table(n_tris, res):
    """bench.py's device-resident table: the sphere in voxel space, padded to
    a power of two, plus its host AABBs."""
    from bench import make_sphere_mesh
    from obj2voxel_tpu_torch.constants import ANTI_BLEED
    from obj2voxel_tpu_torch.engine import _pow2_at_least
    from obj2voxel_tpu_torch.soup import build_tri_table

    tris = make_sphere_mesh(n_tris)
    n = tris.shape[0]
    scale = (res - ANTI_BLEED) / 2.0
    tris = (tris + 1.0) * np.float32(scale) + np.float32(ANTI_BLEED / 2.0)
    n_pad = _pow2_at_least(n)
    verts = np.zeros((n_pad, 3, 3), np.float32)
    verts[:n] = tris
    table = build_tri_table(
        verts, np.zeros((n_pad, 3, 2), np.float32), np.ones(n_pad, np.int32),
        np.ones((n_pad, 3), np.float32), np.full(n_pad, -1, np.int32),
    )
    vmin = np.clip(np.floor(tris.min(axis=1)), 0, res).astype(np.int64)
    vmax = np.clip(np.floor(tris.max(axis=1)) + 1, 0, res).astype(np.int64)
    return table, (vmin, vmax)


def compare_pass(got, want, what):
    """K1 outputs: keys, count and order equal; weights to rtol 1e-6."""
    n = int(want[5].item())
    if int(got[5].item()) != n:
        fail(f"{what}: count {int(got[5].item())} != {n}")
    if not torch.equal(got[0], want[0]):
        fail(f"{what}: keys differ")
    err = 0.0
    for g, w in zip(got[1:5], want[1:5]):
        if not torch.allclose(g, w, rtol=1e-6, atol=0.0):
            fail(f"{what}: channels differ beyond rtol 1e-6")
        err = max(err, float((g - w).abs().max()))
    return n, err


def phase_k1(stats):
    from obj2voxel_tpu_torch.ops.pass_fused import fused_pass, fused_pass_ref
    from obj2voxel_tpu_torch.ops.plan_device import gather_ordered, plan_mesh_device

    t0 = time.perf_counter()
    table_np, _ = sphere_table(SPHERE_TRIS, SPHERE_RES)
    table = torch.from_numpy(table_np).cuda()
    order, segs = plan_mesh_device(table, SPHERE_TRIS, SPHERE_RES, SPHERE_RES,
                                   4 * BUDGET, group=8)
    ordered = gather_ordered(table, order, segs[-1].r1, 8)
    seg = segs[len(segs) // 2]
    z_lo, z_hi = seg.z_lo, seg.z_hi
    r0 = min(s.r0 for s in segs if (s.z_lo, s.z_hi) == (z_lo, z_hi))
    details, err = [], 0.0
    for expand in (1, 8, 64, BUDGET):
        n_rows = min(BUDGET // expand, ordered.shape[0] - r0)
        args = (ordered, r0, n_rows, 0, z_lo, z_hi, SPHERE_RES)
        kw = dict(expand=expand, budget=BUDGET, wide_local=False)
        n, e = compare_pass(fused_pass(*args, **kw), fused_pass_ref(*args, **kw),
                            f"K1 expand={expand}")
        details.append(f"e{expand}:{n}")
        err = max(err, e)
        if expand == 8:
            stats["fused_pass"].update(
                ms=cuda_ms(lambda: fused_pass(*args, **kw)),
                plain_ms=cuda_ms(lambda: fused_pass_ref(*args, **kw), reps=3),
            )
    # one giant slanted triangle at 2048^3: AABB 2048 x 2048 x 4 = 2^24 slots
    giant = np.zeros((1, 24), np.float32)
    giant[0, 0:9] = [0.5, 0.5, 0.5, 2047.5, 0.5, 3.5, 0.5, 2047.5, 3.5]
    giant[0, 17:20] = [0.2, 0.4, 0.8]
    giant_t = torch.from_numpy(giant).cuda()
    for local_base in (1 << 23, (1 << 23) + BUDGET):
        args = (giant_t, 0, 1, local_base, 0, 510, 2048)
        kw = dict(expand=BUDGET, budget=BUDGET, wide_local=True)
        n, e = compare_pass(fused_pass(*args, **kw), fused_pass_ref(*args, **kw),
                            f"K1 wide_local base={local_base}")
        if n == 0:
            fail("K1 wide_local pass produced no live pair")
        details.append(f"wide@{local_base}:{n}")
        err = max(err, e)
    stats["fused_pass"]["max_abs_err"] = err
    phase("2 K1 fused_pass vs plain", t0, " ".join(details))


def k2_streams(rng):
    """Key-sorted streams: runs of 1..5000 crossing tile edges (with weight
    ties), one run spanning everything, all INVALID."""
    inv = (1 << 31) - 1
    lengths = rng.integers(1, 5001, size=STREAM // 1000)
    lengths[::7] = rng.integers(1, 4, size=lengths[::7].shape)
    keys = np.repeat(np.arange(lengths.size, dtype=np.int64) * 3, lengths)[:STREAM]
    keys[-STREAM // 10:] = inv
    mixed = keys.astype(np.int32)
    return {
        "runs": mixed,
        "one_run": np.full(STREAM, 12345, np.int32),
        "all_invalid": np.full(STREAM, inv, np.int32),
    }


def phase_k2(stats):
    from obj2voxel_tpu_torch.ops.combine_pallas import (
        segment_combine, segment_combine_ref,
    )

    t0 = time.perf_counter()
    rng = np.random.default_rng(2)
    err, details = 0.0, []
    for name, keys_np in k2_streams(rng).items():
        keys = torch.from_numpy(keys_np).cuda()
        # quantized weights make MAX ties common
        w = torch.from_numpy(rng.integers(1, 5, STREAM).astype(np.float32) / 4).cuda()
        rgb = [torch.from_numpy(rng.random(STREAM, dtype=np.float32)).cuda() * w
               for _ in range(3)]
        for blend in (False, True):
            got = segment_combine(keys, w, *rgb, blend)
            want = segment_combine_ref(keys, w, *rgb, blend)
            if not torch.equal(got[0], want[0]):
                fail(f"K2 {name} blend={blend}: tail keys differ")
            for g, x in zip(got[1:], want[1:]):
                if blend:
                    if not torch.allclose(g, x, rtol=1e-5, atol=1e-6):
                        fail(f"K2 {name} blend: sums beyond rtol 1e-5")
                    err = max(err, float((g - x).abs().max()))
                elif not torch.equal(g, x):
                    fail(f"K2 {name} max: values differ")
            details.append(f"{name}/{'blend' if blend else 'max'}:"
                           f"{int((got[0] != (1 << 31) - 1).sum())}")
            if name == "runs" and blend:
                stats["segment_combine"].update(
                    ms=cuda_ms(lambda: segment_combine(keys, w, *rgb, True)),
                    plain_ms=cuda_ms(lambda: segment_combine_ref(keys, w, *rgb, True)),
                )
    stats["segment_combine"]["max_abs_err"] = err
    phase("3 K2 segment_combine vs plain", t0, " ".join(details))


def phase_k3(stats):
    from obj2voxel_tpu_torch.ops.pack_pallas import pack_exact, pack_exact_ref

    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    details = []
    for frac in (0.0, 0.25, 1.0):
        keys_np = rng.integers(0, 1 << 30, STREAM).astype(np.int32)
        keys_np[rng.random(STREAM) >= frac] = (1 << 31) - 1
        keys = torch.from_numpy(keys_np).cuda()
        vals = tuple(torch.from_numpy(rng.random(STREAM, dtype=np.float32)).cuda()
                     for _ in range(4))
        gk, gv, gc = pack_exact(keys, vals)
        wk, wv, wc = pack_exact_ref(keys, vals)
        if not (torch.equal(gc, wc) and torch.equal(gk, wk)
                and all(torch.equal(a, b) for a, b in zip(gv, wv))):
            fail(f"K3 live fraction {frac}: output differs")
        details.append(f"{frac}:{int(gc.item())}")
        if frac == 0.25:
            stats["pack_exact"].update(
                ms=cuda_ms(lambda: pack_exact(keys, vals)),
                plain_ms=cuda_ms(lambda: pack_exact_ref(keys, vals)),
            )
    stats["pack_exact"]["max_abs_err"] = 0.0
    phase("4 K3 pack_exact vs plain", t0, " ".join(details))


def voxel_dict(soup, device, **kw):
    from obj2voxel_tpu_torch import voxelize_soup

    out = {}
    for xyz, argb in voxelize_soup(soup, device=device, **kw):
        for p, c in zip(xyz.tolist(), argb.tolist()):
            out[tuple(p)] = c
    return out


def phase_e2e():
    from obj2voxel_tpu_torch import BLEND_STRATEGY, MAX_STRATEGY, TriangleSoup

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    n = 20_000
    centers = rng.random((n, 1, 3), dtype=np.float32)
    verts = centers + rng.uniform(-0.01, 0.01, (n, 3, 3)).astype(np.float32)
    soup = TriangleSoup(
        verts=verts.astype(np.float32), uvs=np.zeros((n, 3, 2), np.float32),
        types=np.full(n, 2, np.int32), rgb=rng.random((n, 3), dtype=np.float32),
        tex=np.full(n, -1, np.int32),
    )
    bounds = (np.zeros(3, np.float32), np.ones(3, np.float32))
    details = []
    for strategy, name in ((MAX_STRATEGY, "max"), (BLEND_STRATEGY, "blend")):
        kw = dict(resolution=256, strategy=strategy, bounds=bounds,
                  max_pass_budget=1 << 14)
        gpu = voxel_dict(soup, "cuda", **kw)
        cpu = voxel_dict(soup, "cpu", **kw)
        if set(gpu) != set(cpu):
            fail(f"E2E {name}: voxel sets differ ({len(gpu)} vs {len(cpu)})")
        a = np.array([gpu[k] for k in cpu], np.uint32).view(np.uint8).astype(np.int16)
        b = np.array(list(cpu.values()), np.uint32).view(np.uint8).astype(np.int16)
        lsb = int(np.abs(a - b).max()) if a.size else 0
        if lsb > (1 if strategy == BLEND_STRATEGY else 0):
            fail(f"E2E {name}: colors differ by {lsb} LSB")
        details.append(f"{name}:{len(gpu)} voxels, {lsb} LSB")
    phase("5 end-to-end cuda vs cpu", t0, "; ".join(details))


def phase_closed_forms():
    from obj2voxel_tpu_torch import TriangleSoup, voxelize_soup

    t0 = time.perf_counter()
    corners = np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
                        [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], np.float32)
    quads = [[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1], [2, 3, 7, 6],
             [0, 2, 6, 4], [1, 5, 7, 3]]
    tris = np.stack([corners[[q[0], q[1], q[2]]] for q in quads]
                    + [corners[[q[0], q[2], q[3]]] for q in quads])
    soup = TriangleSoup.from_vertices(tris)
    details = []
    for r, want in ((1024, 6_279_176), (2048, 25_141_256)):
        got = sum(x.shape[0] for x, _ in voxelize_soup(soup, resolution=r,
                                                        device="cuda"))
        if got != want or want != 8 + 12 * (r - 2) + 6 * (r - 2) ** 2:
            fail(f"cube r={r}: {got} voxels, want {want}")
        details.append(f"r{r}:{got}")
    phase("6 closed forms (unit cube)", t0, " ".join(details))


def phase_real_size(info):
    import obj2voxel_tpu_torch as pt
    from obj2voxel_tpu_torch.engine import MAX_PASS_BUDGET

    t0 = time.perf_counter()
    table_np, aabb = sphere_table(SPHERE_TRIS, SPHERE_RES)
    table = pt.table_from_numpy(table_np, "cuda")

    def run():
        voxels, checks = 0, []
        for xyz, argb, count in pt.stream_slabs(
            table, aabb_host=aabb, stride=SPHERE_RES, z_extent=SPHERE_RES,
            is_blend=True, pair_tile=MAX_PASS_BUDGET, device_outputs=True,
        ):
            voxels += count
            # touch every output byte on the device
            checks.append(argb[:count].view(torch.int32).sum() + xyz[:count].sum())
        if checks:
            torch.stack(checks).sum().item()
        torch.cuda.synchronize()
        return voxels

    pt.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    voxels = run()
    launches = dict(pt.LAUNCHES)
    if voxels != SPHERE_VOXELS:
        fail(f"sphere: {voxels} voxels, want {SPHERE_VOXELS}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"main path launched {name} no time")
    times = []
    for _ in range(3):
        t = time.perf_counter()
        if run() != voxels:
            fail("sphere: voxel count changed between runs")
        times.append(time.perf_counter() - t)
    med = sorted(times)[1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase("7 real size (2M-tri sphere @ 1024^3 BLEND)", t0,
          f"{voxels} voxels; warm median {med:.4f} s = "
          f"{SPHERE_TRIS / med / 1e6:.3f} Mtri/s, {voxels / med / 1e6:.3f} Mvox/s; "
          f"runs {[round(x, 4) for x in times]}; peak {peak:.2f} GiB; "
          f"launches {launches}; on {info}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8")
    want = {int(p) for p in ap.parse_args().phases.split(",")}

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a GPU")
    info = gpu_info()
    print(f"[gpu] {info}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from obj2voxel_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build(verbose=True)
    _cuda.lib()
    phase("1 build", t0, f"nvcc {_cuda.BUILD_SECONDS} s -> {_cuda.library_path().name}")

    stats = {name: {} for name in KERNELS}
    if want & {2, 8}:
        phase_k1(stats)
    if want & {3, 8}:
        phase_k2(stats)
    if want & {4, 8}:
        phase_k3(stats)
    if 5 in want:
        phase_e2e()
    if 6 in want:
        phase_closed_forms()
    launches = {name: 0 for name in KERNELS}
    if 7 in want:
        launches = phase_real_size(info)
    if 8 in want:
        for name, s in stats.items():
            print(f"[phase] 8 {name}: kernel {s['ms']:.4f} ms, plain "
                  f"{s['plain_ms']:.4f} ms ({info})", flush=True)
    if want != {1, 2, 3, 4, 5, 6, 7, 8}:
        print("[partial run: no result line]", flush=True)
        return
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name, (src, rep) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
