"""The port's Instance, CLI and writers against the JAX package's.

Every voxelizing case feeds the same input to `obj2voxel_tpu_torch` on the
CPU (`Instance("cpu")`, `--device cpu`) and to `obj2voxel_tpu`, run op by op
(`jax.disable_jit()`, as the other test_torch_* files do).  Under MAX the
output files must be byte-identical; under BLEND the voxel set must be the
same and each color channel within 1 LSB (the parity contract: the two
packages sum a voxel's colors in different orders).  The writers are also
held to the committed golden bytes under tests/golden/.  The meshes are
small (triangles a few voxels wide) to keep the op-by-op reference quick;
the PNG-textured OBJ's cases are in test_torch_api_textured.py, so that each
file's op-by-op reference stays within a minute.
"""

import struct
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import obj2voxel_tpu as jo
import obj2voxel_tpu_torch as po
from obj2voxel_tpu import constants as C
from obj2voxel_tpu_torch import cli as pcli

torch.set_num_threads(1)

FORMATS = ("vl32", "ply", "xyzrgb", "qef", "vox")


@pytest.fixture(autouse=True)
def _quiet_small_passes(monkeypatch):
    """Silent logs, and 2^12-slot passes for every Instance, the CLI's too:
    the op-by-op reference compiles each op once per shape."""
    for m in (jo, po):
        monkeypatch.setattr(m.constants, "PAIR_TILE", 1 << 12)
        m.set_log_level(C.LOG_LEVEL_SILENT)
    yield
    for m in (jo, po):
        m.set_log_level(C.LOG_LEVEL_INFO)


def _instance(pkg):
    """An Instance of `pkg` on the CPU."""
    return pkg.Instance("cpu") if pkg is po else pkg.Instance()


def _run(pkg, configure, resolution):
    """Voxelize through `pkg`'s Instance into memory; (error code, bytes)."""
    inst = _instance(pkg)
    configure(inst, pkg)
    inst.set_resolution(resolution)
    with jax.disable_jit():
        err = inst.voxelize()
    return err, inst.get_output_memory()


def _vl32(data):
    return np.frombuffer(data, ">u4").reshape(-1, 4)


def _assert_blend_parity(port, ref):
    """Two VL32 byte strings: the same voxels, colors within 1 LSB."""
    p, r = _vl32(port), _vl32(ref)
    assert sorted(map(tuple, p[:, :3].tolist())) == sorted(map(tuple, r[:, :3].tolist()))
    pc = dict(zip(map(tuple, p[:, :3].tolist()), p[:, 3].tolist()))
    rc = dict(zip(map(tuple, r[:, :3].tolist()), r[:, 3].tolist()))
    a = np.array([pc[k] for k in rc], np.uint32).view(np.uint8).astype(np.int16)
    b = np.array(list(rc.values()), np.uint32).view(np.uint8).astype(np.int16)
    assert int(np.abs(a - b).max()) <= 1


def _both(configure, resolution, fmt="vl32", strategy=C.MAX_STRATEGY):
    """The port's and the reference's output bytes for one configuration,
    held to the parity contract; returns the port's."""
    def conf(inst, pkg):
        configure(inst, pkg)
        inst.set_color_strategy(strategy)
        inst.set_output_memory(fmt)

    (je, jb), (pe, pb) = (_run(m, conf, resolution) for m in (jo, po))
    assert je == pe == C.ERR_OK
    if strategy == C.MAX_STRATEGY:
        assert pb == jb
    else:
        _assert_blend_parity(pb, jb)
    return pb


# --- inputs --------------------------------------------------------------------

CUBE_V = [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
          (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)]
CUBE_Q = [(1, 2, 4, 3), (5, 7, 8, 6), (1, 5, 6, 2), (3, 4, 8, 7), (1, 3, 7, 5),
          (2, 6, 8, 4)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The verify recipe's red cube (OBJ + MTL), a seeded OBJ textured by a
    PNG, and a binary STL."""
    d = tmp_path_factory.mktemp("meshes")
    lines = ["mtllib cube.mtl"] + [f"v {x} {y} {z}" for x, y, z in CUBE_V]
    lines += ["usemtl red"] + [f"f {a} {b} {c} {e}" for a, b, c, e in CUBE_Q]
    (d / "cube.obj").write_text("\n".join(lines) + "\n")
    (d / "cube.mtl").write_text("newmtl red\nKd 0.8 0.1 0.1\n")

    from PIL import Image

    rng = np.random.default_rng(11)
    Image.fromarray(rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)).save(d / "tex.png")
    (d / "tex.mtl").write_text("newmtl skin\nKd 0.5 0.5 0.5\nmap_Kd tex.png\n"
                               "newmtl flat\nKd 0.2 0.7 0.3\n")
    n = 60
    verts = (rng.uniform(0, 1, (n, 1, 3)) + rng.uniform(-0.08, 0.08, (n, 3, 3))).reshape(-1, 3)
    uvs = rng.uniform(-1.5, 2.5, (n * 3, 2))
    lines = ["mtllib tex.mtl"] + [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"vt {u:.6f} {v:.6f}" for u, v in uvs]
    for i in range(n):
        if i % 20 == 0:
            lines.append("usemtl flat" if i % 40 else "usemtl skin")
        a, b, c = 3 * i + 1, 3 * i + 2, 3 * i + 3
        lines.append(f"f {a}/{a} {b}/{b} {c}/{c}")
    (d / "tex.obj").write_text("\n".join(lines) + "\n")

    tris = (rng.uniform(-2, 3, (40, 1, 3)) + rng.uniform(-0.3, 0.3, (40, 3, 3))).astype(np.float32)
    rec = np.zeros(40, [("n", "<f4", 3), ("v", "<f4", (3, 3)), ("a", "<u2")])
    rec["v"] = tris
    (d / "mesh.stl").write_bytes(b"\x01" * 80 + struct.pack("<I", 40) + rec.tobytes())
    return d


def test_cube_obj_mtl_matches_jax(files):
    data = _both(lambda i, _: i.set_input_file(str(files / "cube.obj")), 32)
    quads = _vl32(data)
    assert len(quads) == 8 + 12 * 30 + 6 * 30 ** 2 == 5768
    assert set(quads[:, 3].tolist()) == {0xFFCC1A1A}


def test_binary_stl_matches_jax(files):
    data = _both(lambda i, _: i.set_input_file(str(files / "mesh.stl")), 24)
    assert set(_vl32(data)[:, 3].tolist()) == {0xFFFFFFFF}


def _callback(pkg):
    """Input callback of textured, colored and basic triangles sharing two
    textures loaded with load_pixels (RGB and ARGB byte layouts)."""
    rng = np.random.default_rng(4)
    rgb = pkg.Texture()
    rgb.load_pixels(rng.integers(0, 256, 4 * 3 * 3, dtype=np.uint8), 4, 3, 3)
    argb = pkg.Texture()
    argb.load_pixels(rng.integers(0, 256, 2 * 7 * 4, dtype=np.uint8), 2, 7, 4)
    argb.set_uv_mode(C.UV_CLAMP)
    verts = (rng.uniform(0, 1, (50, 1, 3)) + rng.uniform(-0.1, 0.1, (50, 3, 3))).astype(np.float32)
    uvs = rng.uniform(-1, 2, (50, 3, 2)).astype(np.float32)
    colors = rng.random((50, 3), dtype=np.float32)
    state = {"i": 0}

    def next_triangle(tri):
        i = state["i"]
        if i >= len(verts):
            return False
        if i % 3 == 0:
            tri.set_textured(verts[i], uvs[i], rgb if i % 2 else argb)
        elif i % 3 == 1:
            tri.set_colored(verts[i], colors[i])
        else:
            tri.set_basic(verts[i])
        state["i"] += 1
        return True

    return next_triangle


@pytest.mark.parametrize("strategy", [C.MAX_STRATEGY, C.BLEND_STRATEGY],
                         ids=["max", "blend"])
def test_callback_input_matches_jax(strategy):
    data = _both(lambda i, pkg: i.set_input_callback(_callback(pkg)), 16,
                 strategy=strategy)
    assert len(_vl32(data)) > 200


def test_cli_version_names_torch(capsys):
    assert pcli.main(["-V"]) == 0
    out = capsys.readouterr().out
    assert "torch=" in out and "jax" not in out


def test_cli_runs_as_module(files, tmp_path):
    out = tmp_path / "cube.vl32"
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "obj2voxel_tpu_torch.cli",
         str(files / "cube.obj"), str(out), "-r", "8", "--device", "cpu"],
        cwd=root, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(out.read_bytes()) == 16 * (8 + 12 * 6 + 6 * 36)


# --- error codes (the paths of tests/test_api_errors.py) ----------------------

def _basic_input(pkg):
    tri = np.array([[0, 0, 0], [0, 0, 1], [1, 0, 0]], np.float32)
    state = {"done": False}

    def cb(t):
        if state["done"]:
            return False
        t.set_basic(tri)
        state["done"] = True
        return True

    return cb


def _counting_output(data, count):
    assert data.shape == (count, 4)
    return True


@pytest.mark.parametrize("case", ["no_input", "no_output", "no_resolution",
                                  "double", "bad_output_path", "missing_file"])
def test_error_codes_match_jax(case):
    def codes(pkg):
        inst = _instance(pkg)
        if case != "no_input":
            if case == "missing_file":
                inst.set_input_file("/nonexistent_dir_xyz/in.obj")
            else:
                inst.set_input_callback(_basic_input(pkg))
        if case == "bad_output_path":
            inst.set_output_file("/nonexistent_dir_xyz/out.vl32")
        elif case != "no_output":
            inst.set_output_callback(_counting_output)
        if case != "no_resolution":
            inst.set_resolution(4)
        with jax.disable_jit():
            return [inst.voxelize(), inst.voxelize() if case == "double" else None]

    want = {
        "no_input": C.ERR_NO_INPUT, "no_output": C.ERR_NO_OUTPUT,
        "no_resolution": C.ERR_NO_RESOLUTION, "double": C.ERR_OK,
        "bad_output_path": C.ERR_IO_ERROR_ON_OPEN_OUTPUT_FILE,
        "missing_file": C.ERR_IO_ERROR_ON_OPEN_INPUT_FILE,
    }[case]
    got = codes(po)
    assert got == codes(jo)
    assert got[0] == want
    if case == "double":
        assert got[1] == C.ERR_DOUBLE_VOXELIZATION


def test_instance_runs_on_cuda_by_default():
    inst = po.Instance()
    assert inst.device == "cuda"
    inst.set_input_callback(_basic_input(po))
    inst.set_output_callback(_counting_output)
    inst.set_resolution(4)
    if not torch.cuda.is_available():
        # no silent fallback to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            inst.voxelize()


# --- writers ---------------------------------------------------------------------

GOLDEN = Path(__file__).resolve().parent / "golden"


@pytest.mark.parametrize("case,fmt", [
    ("small", f) for f in FORMATS
] + [("scene_graph", "vox"), ("quantized", "vox"), ("quantized", "qef")])
def test_writers_match_golden_bytes(case, fmt):
    import io

    from golden_voxels import CASES

    from obj2voxel_tpu_torch.io.writers import make_writer

    resolution, xyz, argb = CASES[case][0]()
    buf = io.BytesIO()
    w = make_writer(buf, fmt, resolution)
    w.write(xyz[: len(xyz) // 2], argb[: len(xyz) // 2])
    w.write(xyz[len(xyz) // 2 :], argb[len(xyz) // 2 :])
    w.finalize()
    assert buf.getvalue() == (GOLDEN / f"{case}.{fmt}").read_bytes()

