"""Time K1's batched form (`fused_pass_batch`) on one card, in turns, on the
sphere's first batched launch of 8 2^21-slot passes (bench.py's 2M-triangle
sphere at 1024^3, expand 32) and on its first pass alone.

    python3 scripts/ab_batched_pass.py [--parent DIR] [--variant defer=1,min_blocks=3 ...]
                                       [--stamps] [--out FILE]

Candidates, each held to the checkout's outputs (counts and live rows, bit
for bit) and then timed by CUDA events in a palindrome of turns (A B .. B A):
- `this`: the checkout's kernel; `single`: one K1 launch a pass;
- `--parent DIR`: a parent checkout unpacked with `git archive`; its package
  is imported under another name, builds its own kernels, and its batched
  kernel joins the same turns;
- `--variant`: a copy of csrc/ with the batched kernel's `kBatchDefer`
  (`defer`: the clipped tiles a block holds before it looks back), the
  minimum blocks an SM of its launch bounds (`min_blocks`), or, with
  `row_reload=0`, the row pointer kept across the clip instead of rebuilt
  after it, built with nvcc under build/o2v_variants/ (each a scratch build,
  never used by the package); ptxas's registers and spills are printed.
`--stamps` builds a copy with clock64() stamps at the tile body's phase
edges and prints, for the single K1 and the batched kernel, each phase's
share of the summed block time and its cycles a tile: decode (rank decode
and AABB test), queue (ranking the queue), clip (to the slowest thread's
clip end), fan (area and channels, to the block's barrier), epilogue (the
rest: K1's slot-ordered store and tile count; the batched kernel's ranking,
staging, look-back and stores, with the look-back's own wait beside it).
The stamps add barriers, so the stamped kernels' times are not the real
ones.  Prints the card's name and power limit; with --out, writes the
results there as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from obj2voxel_tpu_torch.ops import _cuda  # noqa: E402
from obj2voxel_tpu_torch.ops.pass_fused import fused_pass, fused_pass_batch  # noqa: E402

VARIANT_DIR = REPO / "build" / "o2v_variants"
PHASES = ("decode", "queue", "clip", "fan", "epilogue", "lookback_wait")

# the stamps: (text in fused_pass.cu, text to put after it); each must occur
STAMP_DEFS = """
__shared__ unsigned long long o2v_ph[8];
__shared__ unsigned long long o2v_t, o2v_clip_end;
__device__ unsigned long long* o2v_stamps;
__device__ __forceinline__ void o2v_mark(int phase) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long now = clock64();
    if (phase >= 0) o2v_ph[phase] += now - o2v_t;
    o2v_t = now;
  }
  __syncthreads();
}
__device__ __forceinline__ void o2v_flush(int tiles) {
  __syncthreads();
  if (threadIdx.x < 6) atomicAdd(o2v_stamps + threadIdx.x, o2v_ph[threadIdx.x]);
  if (threadIdx.x == 0) atomicAdd(o2v_stamps + 6, static_cast<unsigned long long>(tiles));
}
"""
STAMPS = [
    ("template <bool TEXTURED>\nconstexpr int kChannels", STAMP_DEFS, "before"),
    ("  // 1. every slot's voxel; the slots inside their AABB join the queue in\n",
     "  if (threadIdx.x == 0) o2v_clip_end = 0;\n  o2v_mark(-1);\n", "before"),
    ("  int n_queue;\n", "  o2v_mark(0);\n", "before"),
    ("  // 2. the first n_queue threads clip the queue\n", "  o2v_mark(1);\n", "before"),
    ("        a, vx, vy, vz, PolyScratch<NCH, COMPACT_TILE>{s_dyn + tid});\n",
     "    atomicMax(&o2v_clip_end, static_cast<unsigned long long>(clock64()));\n",
     "after"),
    ("  if constexpr (!TO_SLOTS) return;\n",
     "  __syncthreads();\n  if (threadIdx.x == 0) {\n"
     "    const unsigned long long now = clock64();\n"
     "    const unsigned long long ce = o2v_clip_end > o2v_t ? o2v_clip_end : o2v_t;\n"
     "    o2v_ph[2] += ce - o2v_t;\n    o2v_ph[3] += now - ce;\n    o2v_t = now;\n  }\n"
     "  __syncthreads();\n", "before"),
    # single K1: the epilogue ends with the tile count
    ("  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;\n",
     "  o2v_mark(4);\n  o2v_flush(1);\n", "after"),
    ("  __shared__ int s_warp[COMPACT_TILE / 32 + 1];\n  int key;\n",
     "  if (threadIdx.x < 8) o2v_ph[threadIdx.x] = 0;\n", "before"),
    # the batched kernel: per-block sums from the start, the look-back's wait
    ("  for (;;) {\n    // the block's place in the chains",
     "  if (threadIdx.x < 8) o2v_ph[threadIdx.x] = 0;\n  int o2v_tiles = 0;\n", "before"),
    ("    const int head = s_head;", "    ++o2v_tiles;\n", "before"),
    ("  if (threadIdx.x < 32) {\n    const int offset = lookback_prefix(",
     "  const unsigned long long o2v_w0 = clock64();\n", "before"),
    ("  const int offset = *s_offset;\n  const int i = threadIdx.x;",
     "  if (threadIdx.x == 0) o2v_ph[5] += clock64() - o2v_w0;\n", "before"),
    ("--s_held;  // after batch_resolve's last barrier\n    }\n", "    o2v_mark(4);\n",
     "after"),
    ("  // the tiles still staged, oldest first\n", "  o2v_mark(-1);\n", "after"),
    ("                  s_ring[e][2], n_tiles, budget, &s_offset);\n  }\n",
     "  o2v_mark(4);\n  o2v_flush(o2v_tiles);\n", "after"),
]
STAMP_SETTER = """
extern "C" int o2v_set_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(o2v_stamps, &p, sizeof(p)));
}
"""


def patch(text, old, new, where="replace"):
    if text.count(old) != 1:
        raise SystemExit(f"patch anchor found {text.count(old)} times: {old!r}")
    if where == "before":
        return text.replace(old, new + old)
    if where == "after":
        return text.replace(old, old + new)
    return text.replace(old, new)


ROW_RELOAD = re.compile(r"    if constexpr \(!TO_SLOTS\) \{\n      // rebuild the row's.*?\n    \}\n",
                        re.S)


def build_variant(tag, defer=None, min_blocks=None, row_reload=None, stamps=False):
    """A copy of csrc/ changed as asked, built into its own library."""
    src_dir = VARIANT_DIR / tag
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src_dir)
    path = src_dir / "fused_pass.cu"
    text = path.read_text()
    if defer is not None:
        text, n = re.subn(r"constexpr int kBatchDefer = \d+;",
                          f"constexpr int kBatchDefer = {defer};", text)
        assert n == 1
    if min_blocks is not None:
        text, n = re.subn(r"__launch_bounds__\([^)]*\)\nfused_pass_batch_kernel",
                          f"__launch_bounds__(COMPACT_TILE, {min_blocks})\n"
                          "fused_pass_batch_kernel", text)
        assert n == 1
    if row_reload == "0":
        text, n = ROW_RELOAD.subn("", text)
        assert n == 1
    if stamps:
        for old, new, where in STAMPS:
            text = patch(text, old, new, where)
        text += STAMP_SETTER
    path.write_text(text)
    so = src_dir / f"lib_{tag}.so"
    flags = [f for f in _cuda.NVCC_FLAGS if f != "--resource-usage"]
    proc = subprocess.run([_cuda._nvcc(), *flags, "-Xptxas", "-v", "-shared", "-o",
                           str(so), str(path)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"variant {tag}: nvcc failed\n{proc.stdout}\n{proc.stderr}")
    usage = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    lib = ctypes.CDLL(str(so))
    for name in ("o2v_fused_pass", "o2v_fused_pass_batch"):
        fn = getattr(lib, name)
        fn.argtypes = _cuda._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib, usage


def on_lib(lib, fn):
    """fn with the package's kernel calls sent to another library."""
    def run():
        saved = _cuda._LIB
        _cuda._LIB = lib
        try:
            return fn()
        finally:
            _cuda._LIB = saved
    return run


def import_parent(parent):
    pkg = Path(parent).resolve() / "obj2voxel_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_pt", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_pt"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_pt.ops.pass_fused")


def palindrome(cands, reps=10):
    """CUDA-event ms of each candidate, timed in the order A B .. B A."""
    order = list(cands) + list(reversed(cands))
    times = {name: [] for name in cands}
    for name in order:
        times[name].append(cs.cuda_ms(cands[name], reps))
    return {name: sum(t) / len(t) for name, t in times.items()}, times


def stamp_split(lib, run):
    buf = torch.zeros(8, dtype=torch.int64, device="cuda")
    if lib.o2v_set_stamps(ctypes.c_void_p(buf.data_ptr())):
        raise SystemExit("o2v_set_stamps failed")
    buf.zero_()
    on_lib(lib, run)()
    torch.cuda.synchronize()
    sums = buf.tolist()
    total = sum(sums[:5])
    tiles = sums[6]
    return {"tiles": tiles, "cycles_per_tile": total / tiles,
            **{p: sums[i] / total for i, p in enumerate(PHASES)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    info = cs.gpu_info()
    print(f"[gpu] {info}", flush=True)
    table_np, aabb = cs.sphere_table(cs.SPHERE_TRIS, cs.SPHERE_RES)
    ordered, batches = cs.sphere_batches(torch.from_numpy(table_np).cuda(), aabb)
    expand, budget, passes, _ = batches[0]
    kw = dict(expand=expand, budget=budget)
    want8 = fused_pass_batch(ordered, passes, **kw)
    want1 = fused_pass_batch(ordered, passes[:1], **kw)

    b8 = {"this": lambda: fused_pass_batch(ordered, passes, **kw),
          "single": lambda: [fused_pass(ordered, *p, **kw) for p in passes]}
    b1 = {"this": lambda: fused_pass_batch(ordered, passes[:1], **kw),
          "single": lambda: fused_pass(ordered, *passes[0], **kw)}
    result = {"gpu": info, "passes": len(passes), "expand": expand, "budget": budget,
              "ptxas": {}}
    if args.parent:
        parent = import_parent(args.parent)
        b8["parent"] = lambda: parent.fused_pass_batch(ordered, passes, **kw)
        b1["parent"] = lambda: parent.fused_pass_batch(ordered, passes[:1], **kw)
        cs.compare_batch(b8["parent"](), want8, "parent batch of 8")
    for spec in args.variant:
        opts = dict(kv.split("=") for kv in spec.split(","))
        tag = "v_" + "_".join(f"{k}{v}" for k, v in sorted(opts.items()))
        lib, usage = build_variant(tag, defer=opts.get("defer"),
                                   min_blocks=opts.get("min_blocks"),
                                   row_reload=opts.get("row_reload"))
        result["ptxas"][tag] = usage
        print(f"[variant] {tag}: {usage}", flush=True)
        b8[tag] = on_lib(lib, b8["this"])
        b1[tag] = on_lib(lib, b1["this"])
        cs.compare_batch(b8[tag](), want8, f"{tag} batch of 8")
        cs.compare_batch(b1[tag](), want1, f"{tag} batch of 1")
    for label, cands in (("B8", b8), ("B1", b1)):
        means, runs = palindrome(cands)
        result[label] = {"ms": means, "runs": runs}
        print(f"[{label}] " + ", ".join(f"{k} {v:.4f} ms" for k, v in means.items()),
              flush=True)
    if args.stamps:
        lib, usage = build_variant("stamps", stamps=True)
        lib.o2v_set_stamps.argtypes = [ctypes.c_void_p]
        lib.o2v_set_stamps.restype = ctypes.c_int
        result["stamps"] = {
            "single K1 x8": stamp_split(lib, b8["single"]),
            "batched B8": stamp_split(lib, b8["this"]),
        }
        result["ptxas"]["stamps"] = usage
        cs.compare_batch(on_lib(lib, b8["this"])(), want8, "stamped batch of 8")
        for k, v in result["stamps"].items():
            print(f"[stamps] {k}: " + ", ".join(
                f"{p} {v[p]:.3f}" for p in PHASES) +
                f"; {v['cycles_per_tile']:.0f} cycles a tile over {v['tiles']} tiles",
                flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in ("B8", "B1")}))


if __name__ == "__main__":
    main()
