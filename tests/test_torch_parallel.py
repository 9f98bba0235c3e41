"""The multi-device path (obj2voxel_tpu_torch/parallel/mesh.py) on CPU
devices: a device listed k times runs k windows in turn, and "cpu" beside
"cpu:0" gives two worker threads.

Parity: against the port's single-device `voxelize_soup` with the same
options (the voxel set exactly, MAX colors byte for byte, BLEND within
1 LSB), and against the JAX package's `voxelize_sharded(n_devices=3)` on
the unit cube (exactly; tests/fixtures/jax_parallel.npz holds its output,
scripts/jax_test_references.py); `_device_windows` equal to the JAX
function's.
"""

import numpy as np
import pytest
import torch

from conftest import (
    UNIT_CUBE_QUADS, UNIT_CUBE_VERTICES, expected_unit_cube_voxels, quads_to_tris,
)
from jax_reference import reference, voxel_dict
from obj2voxel_tpu.parallel import mesh as jmesh
import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import api as tapi
from obj2voxel_tpu_torch import constants as C
from obj2voxel_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

CUBE = quads_to_tris(UNIT_CUBE_VERTICES, UNIT_CUBE_QUADS)
BOUNDS = (np.zeros(3, np.float32), np.ones(3, np.float32))


def _voxels(batches):
    out = {}
    for xyz, argb in batches:
        assert xyz.dtype == np.int32 and argb.dtype == np.uint32
        for p, c in zip(xyz.tolist(), argb.tolist()):
            assert tuple(p) not in out, "voxel emitted twice"
            out[tuple(p)] = c
    return out


def _max_lsb(a, b):
    keys = list(a)
    x = np.array([a[k] for k in keys], np.uint32).view(np.uint8).astype(np.int16)
    y = np.array([b[k] for k in keys], np.uint32).view(np.uint8).astype(np.int16)
    return int(np.abs(x - y).max()) if keys else 0


def _random_soup(n=300, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.random((n, 1, 3), dtype=np.float32)
    return pt.TriangleSoup(
        verts=(centers + rng.uniform(-0.05, 0.05, (n, 3, 3))).astype(np.float32),
        uvs=np.zeros((n, 3, 2), np.float32),
        types=np.full(n, C.TRI_UNTEXTURED, np.int32),
        rgb=rng.random((n, 3), dtype=np.float32),
        tex=np.full(n, -1, np.int32),
    )


#: name -> (soup, options); the random soup's small budgets give several
#: slabs a window
CASES = {
    "cube": (lambda: pt.TriangleSoup.from_vertices(CUBE),
             dict(resolution=16, pair_tile=1 << 12)),
    "random_max": (_random_soup, dict(resolution=64, bounds=BOUNDS, pair_tile=1 << 12,
                                      max_pass_budget=1 << 12)),
    "blend_ss2": (_random_soup, dict(resolution=32, supersampling=2, bounds=BOUNDS,
                                     strategy=C.BLEND_STRATEGY, pair_tile=1 << 12,
                                     max_pass_budget=1 << 12)),
}


@pytest.fixture(scope="module")
def single():
    return {name: _voxels(pt.voxelize_soup(make(), device="cpu", **kw))
            for name, (make, kw) in CASES.items()}


@pytest.mark.parametrize("z_extent", [1, 2, 7, 16, 64, 100, 1023, 1024])
def test_device_windows_match_jax(z_extent):
    for n in (1, 2, 3, 4, 5, 8, 16):
        assert tmesh._device_windows(z_extent, n) == jmesh._device_windows(z_extent, n)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_windows_match_one_device(single, case, k):
    make, kw = CASES[case]
    got = _voxels(tmesh.stream_sharded(make(), devices=["cpu"] * k, **kw))
    want = single[case]
    assert set(got) == set(want) and len(got) > 1000
    blend = kw.get("strategy") == C.BLEND_STRATEGY
    assert _max_lsb(got, want) <= (1 if blend else 0)


def test_no_batch_straddles_a_window():
    windows, _ = tmesh._device_windows(64, 3)
    n_batches = 0
    for xyz, _ in tmesh.stream_sharded(_random_soup(), devices=["cpu"] * 3,
                                       resolution=64, bounds=BOUNDS,
                                       pair_tile=1 << 10, max_pass_budget=1 << 10):
        lo, hi = int(xyz[:, 2].min()), int(xyz[:, 2].max())
        assert any(z0 <= lo and hi < z1 for z0, z1 in windows)
        n_batches += 1
    assert n_batches > 3  # several slabs a window


def test_two_worker_threads_match_one_device(single):
    make, kw = CASES["random_max"]
    got = _voxels(tmesh.stream_sharded(make(), devices=["cpu", "cpu:0"],
                                       n_devices=5, **kw))
    assert got == single["random_max"]


#: the sharded cube's options: r = 8 kept the jitted JAX reference's
#: compiles to ~2 minutes
SHARDED = dict(resolution=8, tile_size=1 << 12, pair_tile=1 << 12)


def test_cube_matches_jax_voxelize_sharded():
    # the JAX reference ran jitted, as tests/test_parallel.py runs it (op by
    # op, its shard_map programs do not finish in minutes)
    xyz, argb = tmesh.voxelize_sharded(pt.TriangleSoup.from_vertices(CUBE),
                                       devices=["cpu"] * 3, **SHARDED)
    ref = reference("parallel", "cube_sharded", CUBE, n_devices=3, **SHARDED)
    assert xyz.shape[0] == expected_unit_cube_voxels(8)
    assert _voxels([(xyz, argb)]) == voxel_dict(ref)


def test_worker_failure_reaches_the_caller(monkeypatch):
    def broken(*args, **kw):
        raise RuntimeError("window failed")
        yield  # a generator, like stream_slabs

    monkeypatch.setattr(tmesh, "stream_slabs", broken)
    make, kw = CASES["cube"]
    with pytest.raises(RuntimeError, match="window failed"):
        list(tmesh.stream_sharded(make(), devices=["cpu", "cpu:0"], **kw))


def test_empty_soup_and_no_device():
    assert list(tmesh.stream_sharded(pt.TriangleSoup.empty(), resolution=8,
                                     devices=["cpu"])) == []
    xyz, argb = tmesh.voxelize_sharded(pt.TriangleSoup.empty(), resolution=8,
                                       devices=["cpu"])
    assert xyz.shape == (0, 3) and argb.shape == (0,)
    with pytest.raises(ValueError):
        list(tmesh.stream_sharded(pt.TriangleSoup.from_vertices(CUBE), resolution=8,
                                  devices=[]))


def test_parallel_devices_on_the_cpu():
    assert tmesh.parallel_devices("cpu") == [torch.device("cpu")]


def _instance_bytes(soup, parallel):
    inst = pt.Instance("cpu")
    inst.set_input_soup(soup)
    inst.set_output_memory("vl32")
    inst.set_resolution(64)
    inst.set_parallel(parallel)
    assert inst.voxelize() == C.ERR_OK
    return inst.get_output_memory()


def test_instance_set_parallel_shards_over_the_device_list(monkeypatch):
    calls = []

    def sharded(*args, **kw):
        calls.append(kw["devices"])
        return tmesh.stream_sharded(*args, **kw)

    soup = _random_soup(seed=5)
    want = _instance_bytes(soup, parallel=False)
    monkeypatch.setattr(tapi, "parallel_devices", lambda device: [torch.device("cpu")] * 3)
    monkeypatch.setattr(tapi, "stream_sharded", sharded)
    got = _instance_bytes(soup, parallel=True)
    assert calls == [[torch.device("cpu")] * 3]
    assert len(got) > 16 * 1000
    # one device runs its windows in z order: the same bytes
    assert got == want
    assert _instance_bytes(soup, parallel=False) == want and len(calls) == 1
