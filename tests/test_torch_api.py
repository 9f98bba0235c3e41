"""The port's Instance, CLI and writers against the JAX package's.

Every voxelizing case feeds the same input to `obj2voxel_tpu_torch` on the
CPU (`Instance("cpu")`, `--device cpu`) and compares its output with that of
`obj2voxel_tpu`, run op by op (`jax.disable_jit()`) on the same input, as
tests/fixtures/jax_api.npz holds it (scripts/jax_test_references.py).
Under MAX the output files must be byte-identical; under BLEND the voxel
set must be the same and each color channel within 1 LSB (the parity
contract: the two packages sum a voxel's colors in different orders).  The
writers are also held to the committed golden bytes under tests/golden/.
The PNG-textured OBJ's cases are in test_torch_api_textured.py.
"""

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jax_reference import reference
import obj2voxel_tpu_torch as po
from obj2voxel_tpu_torch import cli as pcli
from obj2voxel_tpu_torch import constants as C

torch.set_num_threads(1)

FORMATS = ("vl32", "ply", "xyzrgb", "qef", "vox")


#: the pass budget of every Instance here, the CLI's too, as the JAX
#: references ran with it (the op-by-op reference compiles each op once per
#: shape)
PAIR_TILE = 1 << 12


@pytest.fixture(autouse=True)
def _quiet_small_passes(monkeypatch):
    """Silent logs, and PAIR_TILE-slot passes."""
    monkeypatch.setattr(po.constants, "PAIR_TILE", PAIR_TILE)
    po.set_log_level(C.LOG_LEVEL_SILENT)
    yield
    po.set_log_level(C.LOG_LEVEL_INFO)


def _instance(pkg):
    """An Instance of `pkg` on the CPU."""
    return pkg.Instance("cpu") if pkg is po else pkg.Instance()


def _run(pkg, configure, resolution, run=lambda inst: inst.voxelize()):
    """Voxelize through `pkg`'s Instance into memory; (error code, bytes)."""
    inst = _instance(pkg)
    configure(inst, pkg)
    inst.set_resolution(resolution)
    err = run(inst)
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


def configured(configure, fmt, strategy):
    """`configure`, then the strategy and an output to memory in `fmt`."""
    def conf(inst, pkg):
        configure(inst, pkg)
        inst.set_color_strategy(strategy)
        inst.set_output_memory(fmt)

    return conf


def _both(case, inputs, configure, resolution, fmt="vl32",
          strategy=C.MAX_STRATEGY):
    """The port's and the reference's output bytes for one configuration,
    held to the parity contract; returns the port's.  `inputs` are the
    arrays the configuration reads (`mesh_inputs`)."""
    pe, pb = _run(po, configured(configure, fmt, strategy), resolution)
    ref = reference("api", case, *inputs, resolution=resolution, fmt=fmt,
                    strategy=strategy, pair_tile=PAIR_TILE)
    je, jb = int(ref["err"]), ref["bytes"].tobytes()
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


def write_meshes(d):
    """The verify recipe's red cube (OBJ + MTL), a seeded OBJ textured by a
    PNG, and a binary STL, written into the directory `d`."""
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


#: each mesh of `write_meshes`: the files it reads
MESH_FILES = {"cube.obj": ("cube.obj", "cube.mtl"), "mesh.stl": ("mesh.stl",),
              "tex.obj": ("tex.obj", "tex.mtl", "tex.png")}


def mesh_inputs(d, mesh):
    """The input arrays of `mesh`: its files' bytes, a PNG's pixels."""
    out = []
    for name in MESH_FILES[mesh]:
        if name.endswith(".png"):
            from PIL import Image

            out.append(np.asarray(Image.open(d / name)))
        else:
            out.append((d / name).read_bytes())
    return out


def file_input(d, mesh):
    """A configure function that reads `mesh` from `d`."""
    return lambda inst, _: inst.set_input_file(str(d / mesh))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    write_meshes(d)
    return d


def test_cube_obj_mtl_matches_jax(files):
    data = _both("cube_obj", mesh_inputs(files, "cube.obj"),
                 file_input(files, "cube.obj"), 32)
    quads = _vl32(data)
    assert len(quads) == 8 + 12 * 30 + 6 * 30 ** 2 == 5768
    assert set(quads[:, 3].tolist()) == {0xFFCC1A1A}


def test_binary_stl_matches_jax(files):
    data = _both("binary_stl", mesh_inputs(files, "mesh.stl"),
                 file_input(files, "mesh.stl"), 24)
    assert set(_vl32(data)[:, 3].tolist()) == {0xFFFFFFFF}


def callback_arrays():
    """The callback's arrays: RGB and ARGB texture bytes, vertices, UVs and
    colors."""
    rng = np.random.default_rng(4)
    rgb_px = rng.integers(0, 256, 4 * 3 * 3, dtype=np.uint8)
    argb_px = rng.integers(0, 256, 2 * 7 * 4, dtype=np.uint8)
    verts = (rng.uniform(0, 1, (50, 1, 3)) + rng.uniform(-0.1, 0.1, (50, 3, 3))).astype(np.float32)
    uvs = rng.uniform(-1, 2, (50, 3, 2)).astype(np.float32)
    colors = rng.random((50, 3), dtype=np.float32)
    return rgb_px, argb_px, verts, uvs, colors


def _callback(pkg):
    """Input callback of textured, colored and basic triangles sharing two
    textures loaded with load_pixels (RGB and ARGB byte layouts)."""
    rgb_px, argb_px, verts, uvs, colors = callback_arrays()
    rgb = pkg.Texture()
    rgb.load_pixels(rgb_px, 4, 3, 3)
    argb = pkg.Texture()
    argb.load_pixels(argb_px, 2, 7, 4)
    argb.set_uv_mode(C.UV_CLAMP)
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
    data = _both(f"callback_{strategy}", callback_arrays(),
                 callback_input, 16, strategy=strategy)
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

def callback_input(inst, pkg):
    inst.set_input_callback(_callback(pkg))


BASIC_TRI = np.array([[0, 0, 0], [0, 0, 1], [1, 0, 0]], np.float32)


def _basic_input(pkg):
    tri = BASIC_TRI
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


ERROR_CASES = ["no_input", "no_output", "no_resolution", "double",
               "bad_output_path", "missing_file"]


def error_codes(pkg, case, run=lambda inst: inst.voxelize()):
    """The codes of one voxelize, and of a second under "double"."""
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
    return [run(inst), run(inst) if case == "double" else None]


@pytest.mark.parametrize("case", ERROR_CASES)
def test_error_codes_match_jax(case):
    want = {
        "no_input": C.ERR_NO_INPUT, "no_output": C.ERR_NO_OUTPUT,
        "no_resolution": C.ERR_NO_RESOLUTION, "double": C.ERR_OK,
        "bad_output_path": C.ERR_IO_ERROR_ON_OPEN_OUTPUT_FILE,
        "missing_file": C.ERR_IO_ERROR_ON_OPEN_INPUT_FILE,
    }[case]
    got = error_codes(po, case)
    ref = reference("api", f"errors_{case}", BASIC_TRI, case=case)["codes"]
    assert got == [None if c < 0 else int(c) for c in ref]
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

