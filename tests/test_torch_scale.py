"""The reference-scale entry points of the port on the CPU, at small sizes:
the bench entry (obj2voxel_tpu_torch.bench, bench.py's counterpart), the
scale runs (obj2voxel_tpu_torch.scale, scripts/scale_proof.py's), their
meshes and STL writer against the originals', the STL reader, and reduced
BASELINE configs 4 (an STL at 2048^3) and 6 (a helix at 8192^3, planned on
the host in more than 32 slabs) through `Instance`, byte for byte against
the JAX package's `Instance` on the same files.

The JAX side of the reduced configs is a committed fixture,
tests/fixtures/jax_scale.npz, written by scripts/jax_scale_reference.py
(the JAX package op by op on the CPU takes minutes there) and held to the
STL bytes it came from by their sha256.
"""

import hashlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import bench, engine, scale
from obj2voxel_tpu_torch.io import stl_loader
from obj2voxel_tpu_torch.ops.expand_bucket import plan_adaptive_slabs
from obj2voxel_tpu_torch.ops.plan_device import MAX_DEVICE_SLABS
from obj2voxel_tpu_torch.utils.log import log
from obj2voxel_tpu_torch.utils.meshes import make_helix_mesh, make_sphere_mesh, write_stl

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_scale.npz"


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scale_proof():
    return _module("scripts/scale_proof.py", "scale_proof")


@pytest.fixture(scope="module")
def reference():
    """scripts/jax_scale_reference.py: the reduced configs' meshes."""
    return _module("scripts/jax_scale_reference.py", "jax_scale_reference")


@pytest.mark.parametrize("n_tris", [2_000_000, 10_000_000])
def test_sphere_mesh_equals_bench_py(n_tris):
    sys.path.insert(0, str(REPO))
    import bench as jax_bench

    want = jax_bench.make_sphere_mesh(n_tris)
    got = make_sphere_mesh(n_tris)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("kw", [{}, {"turns": 0.25, "tube_r": 2.5e-5}])
def test_helix_mesh_equals_scale_proof(scale_proof, kw):
    want = scale_proof.make_helix_mesh(100_000, **kw)
    got = make_helix_mesh(100_000, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape == (99_996, 3, 3)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_write_stl_equals_scale_proof(scale_proof, tmp_path):
    tris = make_helix_mesh(600)
    scale_proof.write_stl(str(tmp_path / "a.stl"), tris)
    write_stl(str(tmp_path / "b.stl"), tris)
    assert (tmp_path / "a.stl").read_bytes() == (tmp_path / "b.stl").read_bytes()


@pytest.mark.parametrize("chunk", [stl_loader.CHUNK_RECORDS, 7])
def test_stl_round_trip(monkeypatch, tmp_path, chunk):
    """write_stl -> load_stl gives the triangles back, bit for bit, whether
    the records fit one chunk or cross chunk edges; a truncated file is
    refused."""
    monkeypatch.setattr(stl_loader, "CHUNK_RECORDS", chunk)
    monkeypatch.setenv("O2V_NO_NATIVE", "1")
    monkeypatch.setattr("obj2voxel_tpu_torch.io.native._TRIED", False)
    monkeypatch.setattr("obj2voxel_tpu_torch.io.native._LIB", None)
    tris = make_sphere_mesh(100) * np.float32(3.5)
    path = tmp_path / "m.stl"
    write_stl(str(path), tris)
    soup = stl_loader.load_stl(str(path))
    assert np.array_equal(soup.verts.view(np.uint32), tris.view(np.uint32))
    assert (soup.types == pt.constants.TRI_MATERIALLESS).all()
    path.write_bytes(path.read_bytes()[:-1])
    assert stl_loader.load_stl(str(path)) is None


def test_read_verts_refuses_a_short_read():
    """A file that ends inside the records it was asked for gives None,
    never vertices read from uninitialized memory."""
    tris = make_sphere_mesh(100)[:3]
    buf = io.BytesIO()
    for tri in tris:
        buf.write(np.zeros(3, "<f4").tobytes() + tri.astype("<f4").tobytes() + b"\0\0")
    data = buf.getvalue()
    got = stl_loader._read_verts(io.BytesIO(data), 3)
    assert np.array_equal(got.view(np.uint32), tris.view(np.uint32))
    assert stl_loader._read_verts(io.BytesIO(data[:-1]), 3) is None


def test_textured_sphere_table_keeps_the_geometry():
    """bench.sphere_table's textured form (chip_smoke.py's textured paths)
    has the untextured one's vertices, colors and AABBs; its rows are
    TRI_TEXTURED with texture 0 and the sphere's UVs."""
    plain, aabb, n = bench.sphere_table(2000, 32)
    tex, tex_aabb, tex_n = bench.sphere_table(2000, 32, textured=True)
    _, uvs = make_sphere_mesh(2000, uvs=True)
    assert n == tex_n == uvs.shape[0]
    assert all(np.array_equal(a, b) for a, b in zip(aabb, tex_aabb))
    geometry = np.r_[0:9, 17:20]
    assert np.array_equal(plain[:, geometry], tex[:, geometry])
    assert (plain[:n, 16] == pt.constants.TRI_MATERIALLESS).all() and (plain[:n, 20] == -1).all()
    assert (tex[:n, 16] == pt.constants.TRI_TEXTURED).all() and (tex[:n, 20] == 0).all()
    assert np.array_equal(tex[:n, 9:15], uvs.reshape(n, 6)) and not plain[:, 9:15].any()


@pytest.mark.parametrize("mode", bench.MODES)
def test_bench_mode_counts_as_the_engine(mode):
    """Each bench mode at 2000 triangles and 32^3 counts what the engine
    gives for the same input; its JSON line has bench.py's keys."""
    n, voxels, times = bench.run_mode(2000, 32, mode, "cpu")
    assert len(times) == 3
    if mode == "host":
        soup = pt.TriangleSoup.from_vertices(make_sphere_mesh(2000))
        want = sum(x.shape[0] for x, _ in pt.voxelize_soup(
            soup, resolution=32, strategy=pt.BLEND_STRATEGY, device="cpu"))
    else:
        table, aabb, _ = bench.sphere_table(2000, 32)
        want = sum(x.shape[0] for x, _ in pt.stream_slabs(
            torch.from_numpy(table), aabb_host=aabb, stride=32, z_extent=32,
            is_blend=True))
    assert n == 1984 and voxels == want > 0
    line = bench.result_line(n, voxels, sorted(times)[1], 32, mode)
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert f"({n} tris, {voxels} voxels, " in line["metric"]


def test_bench_main_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main(["2000", "32", "device"])


def test_occupancy_digest_is_the_voxel_set(monkeypatch):
    """The digest of chip_smoke.py's 10M gate covers the voxel set alone:
    the host planner gives the device planner's digest, and batches in
    another order give the same."""
    sphere = bench.upload_sphere(2000, 32, "cpu")
    want = bench.sphere_occupancy(sphere, 32)
    monkeypatch.setenv("O2V_HOST_PLAN", "1")
    assert bench.sphere_occupancy(sphere, 32) == want
    xyz = np.concatenate([x for x, _ in bench._stream(sphere, 32, False)])
    assert bench.occupancy_sha256(np.array_split(xyz, 3)[::-1], 32) == want


def test_slab_keys_fit_int32_at_8192():
    """Config 6's helix at 8192^3: every slab's slab-local keys fit int32
    (height * r^2 < 2^31, so at most 31 layers), there are more than
    MAX_DEVICE_SLABS of them, and the finalize decodes the largest key."""
    r = 8192
    tris = make_helix_mesh(100_000) * np.float32(r - 1)
    vmin = np.clip(np.floor(tris.min(axis=1)), 0, r).astype(np.int64)
    vmax = np.clip(np.floor(tris.max(axis=1)) + 1, 0, r).astype(np.int64)
    slabs = plan_adaptive_slabs(vmin, vmax, r, r, 4 * engine.MAX_PASS_BUDGET)
    assert len(slabs) > MAX_DEVICE_SLABS
    assert slabs[0][0] == 0 and slabs[-1][1] == r
    assert all((hi - lo) * r * r < 2**31 and hi - lo <= 31 for lo, hi in slabs)
    z_lo, z_hi = slabs[-1]
    key = torch.tensor([(z_hi - 1 - z_lo) * r * r + (r - 1) * r + r - 2], dtype=torch.int32)
    chans = tuple(torch.ones(1) for _ in range(4))
    xyz, _, _ = engine._finalize_merge(key, chans, 1, z_lo, r)
    assert xyz.tolist() == [[r - 2, r - 1, z_hi - 1]]


@pytest.mark.parametrize("case", ["config4", "config6"])
def test_reduced_config_matches_jax(reference, tmp_path, case):
    """A reduced config through the port's `Instance` on the CPU into a VL32
    file: the JAX package's `Instance` bytes (the fixture), and config 6
    planned on the host in more than 32 slabs."""
    build, res = reference.CASES[case]
    ref = np.load(FIXTURE)
    stl, out = tmp_path / "mesh.stl", tmp_path / "out.vl32"
    write_stl(str(stl), build())
    digest = hashlib.sha256(stl.read_bytes()).hexdigest()
    assert str(ref[f"{case}_stl_sha256"]) == digest, "the fixture is of another STL"
    assert int(ref[f"{case}_res"]) == res
    result = scale.voxelize_file(str(stl), str(out), res, device="cpu")
    assert result["exit"] == pt.ERR_OK
    assert result["voxels"] == int(ref[f"{case}_voxels"]) > 0
    assert out.read_bytes() == ref[f"{case}_vl32"].tobytes()
    assert result["vl32_sha256"] == str(ref[f"{case}_vl32_sha256"])
    stats = result["wave_stats"]
    if case == "config6":
        assert stats["slabs"] > MAX_DEVICE_SLABS and stats["host_plan"] == 1
    else:
        assert 1 < stats["slabs"] <= MAX_DEVICE_SLABS and stats["host_plan"] == 0
    # an STL carries no color: every voxel is the one white of MAX
    argb = np.frombuffer(out.read_bytes(), ">u4").reshape(-1, 4)[:, 3]
    assert (argb == argb[0]).all()


def test_scale_main_prints_scale_proof_fields(capsys, monkeypatch, tmp_path):
    """A shrunk config 6 through the scale CLI under O2V_TIMING=1: the
    engine's `[o2v-timing]` lines of every stage, then scale_proof.py's
    fields with host seconds by stage summed from those lines; the log
    level is the caller's again afterwards."""
    monkeypatch.setitem(scale.CONFIGS, 6, (1200, 96))
    monkeypatch.setenv("O2V_TIMING", "1")
    level = log.get_level()
    scale.main(["6", "--device", "cpu", "--dir", str(tmp_path)])
    assert log.get_level() == level
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    for key in ("config", "desc", "exit", "voxels", "wall_s", "peak_rss_gb",
                "peak_device_gib", "vl32_sha256", "wave_stats", "stage_s"):
        assert key in line, key
    assert line["config"] == 6 and line["exit"] == 0 and line["voxels"] > 0
    assert line["peak_device_gib"] == 0.0 and line["peak_rss_gb"] > 0
    assert (tmp_path / "o2v_scale_6.vl32").stat().st_size == 16 * line["voxels"]
    stages = line["stage_s"]
    assert set(stages) == {"load", "prepare", "table", "plan", "passes", "merges",
                           "pulls", "write", "other"}
    # the stages do not nest: what is left of the wall time is not negative
    assert min(stages.values()) >= -0.001
    assert sum(stages.values()) == pytest.approx(line["wall_s"], abs=0.01)
    for text in ("load ", "prepare ", r"table\+upload ", r"plan\+gather ",
                 "  wave: ", r"  \d+ merges ", r"  \d+ pulls ", "write "):
        assert any(re.match(rf"\[o2v-timing\] {text}", x) for x in out), text
