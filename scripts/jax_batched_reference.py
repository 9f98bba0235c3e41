"""The JAX package's batched stream on tests/test_pipeline.py:161's soup, as
a fixture for tests/test_torch_stream_knobs.py.

The soup (6000 translated copies of one triangle at r 64, pair tile 2^14;
white, and with a random color a copy) goes through the JAX package's
`voxelize_soup` with O2V_BATCH=8 and O2V_BATCH_FORCE=1, jitted, as
tests/test_pipeline.py's batched case runs it: the fused pass's batched
Pallas kernel in interpret mode.  On the CPU that takes some four minutes,
mostly XLA compiles (one per batch size), far past what one test file may
spend, so the voxels and `WAVE_STATS` of each case are written once to
tests/fixtures/jax_batched_soup.npz, with a digest of the soup they came
from.  The reference is frozen, so the fixture stays valid until the soup
changes.

    JAX_PLATFORMS=cpu python3 scripts/jax_batched_reference.py

Prints one line a case: its voxels, its WAVE_STATS and its seconds.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
OUT = REPO / "tests" / "fixtures" / "jax_batched_soup.npz"

#: (case, colored, strategy): MAX and BLEND
CASES = (("white_max", False, 0), ("colored_max", True, 0), ("colored_blend", True, 1))


def soup_arrays(colored):
    """(verts, rgb) of tests/test_pipeline.py:161's soup: translated copies
    of one triangle at integer offsets; with `colored`, a random color a
    copy (tests/test_torch_stream_knobs.py builds the same)."""
    rng = np.random.RandomState(7)
    base = np.array([[0.2, 0.2, 0.3], [1.4, 0.3, 0.4], [0.3, 1.4, 1.3]], np.float32)
    offs = rng.randint(0, 60, size=(6000, 1, 3)).astype(np.float32)
    verts = (base[None] + offs).reshape(-1, 3, 3)
    rgb = (rng.rand(verts.shape[0], 3).astype(np.float32) if colored
           else np.ones((verts.shape[0], 3), np.float32))
    return verts, rgb


def soup_digest(colored):
    h = hashlib.sha256()
    for a in soup_arrays(colored):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from obj2voxel_tpu import constants as C
    from obj2voxel_tpu import engine

    os.environ["O2V_BATCH"] = "8"
    os.environ["O2V_BATCH_FORCE"] = "1"
    bounds = (np.zeros(3, np.float32), np.full(3, 62.0, np.float32))
    arrays = {}
    for name, colored, strategy in CASES:
        verts, rgb = soup_arrays(colored)
        n = verts.shape[0]
        types = np.full(n, C.TRI_UNTEXTURED if colored else C.TRI_MATERIALLESS,
                        np.int32)
        soup = engine.TriangleSoup(verts, np.zeros((n, 3, 2), np.float32), types,
                                   rgb, np.full(n, -1, np.int32))
        t = time.perf_counter()
        out = list(engine.voxelize_soup(soup, resolution=64, pair_tile=1 << 14,
                                        bounds=bounds, strategy=strategy))
        secs = time.perf_counter() - t
        stats = dict(engine.WAVE_STATS)
        arrays[f"{name}_xyz"] = np.concatenate([x for x, _ in out])
        arrays[f"{name}_argb"] = np.concatenate([a for _, a in out])
        arrays[f"{name}_stats"] = np.array(
            [stats["passes"], stats["dispatches"], stats["batched"]], np.int64)
        arrays[f"{name}_soup"] = np.array(soup_digest(colored))
        print(f"{name}: {arrays[f'{name}_xyz'].shape[0]} voxels, {stats}, "
              f"{secs:.1f} s", flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT.relative_to(REPO)} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
