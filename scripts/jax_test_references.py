"""The JAX package's outputs on the inputs of the port's tests, as fixtures.

The port's tests (tests/test_torch_*.py) hold `obj2voxel_tpu_torch` to
`obj2voxel_tpu`.  The JAX package is frozen, so its outputs on fixed inputs
cannot change; running it on every test run only cost the clock (an op-by-op
`voxelize_soup` takes tens of seconds on the CPU, a jitted
`voxelize_sharded` or an interpret-mode Pallas kernel minutes).  This script
makes the same JAX calls on the same inputs, the same way the tests made
them (op by op under `jax.disable_jit()`, or jitted where they ran jitted),
and writes one tests/fixtures/jax_<group>.npz a group.  For each case it
stores the sha256 of the case's inputs (tests/jax_reference.py `digest`)
and the outputs the test compares: voxel sets as xyz and ARGB, output files
as their bytes, kernels' raw arrays.  The inputs come from the test modules'
own input functions, so a test and its fixture cannot drift apart
unnoticed: the test checks the digest before it compares.

    JAX_PLATFORMS=cpu python3 scripts/jax_test_references.py [group ...]

With no group it writes them all (some 15 minutes on one CPU core; groups
are independent, so they may run as parallel processes).  Prints one line a
case with its seconds, and each file's size.  tests/fixtures/jax_scale.npz
and jax_batched_soup.npz have scripts of their own
(scripts/jax_scale_reference.py, scripts/jax_batched_reference.py).
"""

from __future__ import annotations

import io
import os
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from jax_reference import digest, fixture_path, voxel_arrays  # noqa: E402

GROUPS = {}


def group(fn):
    GROUPS[fn.__name__] = fn
    return fn


class Cases:
    """The cases of one group: `add(case, arrays, params, outputs)`."""

    def __init__(self, name):
        self.name, self.arrays, self.t = name, {}, time.perf_counter()

    def add(self, case, arrays, params, outputs):
        assert f"{case}__sha256" not in self.arrays, case
        self.arrays[f"{case}__sha256"] = np.array(digest(*arrays, **params))
        for k, v in outputs.items():
            self.arrays[f"{case}__{k}"] = np.asarray(v)
        now = time.perf_counter()
        print(f"{self.name}/{case}: {now - self.t:.1f} s", flush=True)
        self.t = now

    def write(self):
        buf = io.BytesIO()
        np.savez_compressed(buf, **self.arrays)
        path = fixture_path(self.name)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(buf.getvalue())
        print(f"wrote {path.relative_to(REPO)} ({path.stat().st_size} bytes)",
              flush=True)


@contextmanager
def op_by_op():
    import jax

    with jax.disable_jit():
        yield


@contextmanager
def tables_checked_against_jax(module):
    """`module` builds its tables with the port's `build_tri_table`, and the
    fixture's JAX outputs are computed on them: check that the JAX package's
    builder gives the same bytes on the same arrays, for every table built."""
    from obj2voxel_tpu import engine as jeng

    port_build = module.build_tri_table

    def build(*args, **kw):
        table = port_build(*args, **kw)
        jax_table = jeng.build_tri_table(*args, **kw)
        assert (table.dtype, table.shape) == (jax_table.dtype, jax_table.shape)
        assert table.tobytes() == jax_table.tobytes(), (
            f"{module.__name__}: the port's build_tri_table differs from the "
            "JAX package's")
        return table

    module.build_tri_table = build
    try:
        yield
    finally:
        module.build_tri_table = port_build


def _jax_soup(arrays):
    from obj2voxel_tpu import engine as jeng

    return jeng.TriangleSoup(*(np.array(a) for a in arrays))


def _jax_pool(textures):
    from obj2voxel_tpu.ops.color import TexturePool

    pool = TexturePool()
    for img, wrap in textures:
        pool.add(img, wrap)
    return pool


def _voxelize(arrays, pool=None, **kw):
    """The JAX `voxelize_soup` of a soup's five arrays, op by op."""
    from obj2voxel_tpu import engine as jeng

    with op_by_op():
        return voxel_arrays(jeng.voxelize_soup(_jax_soup(arrays), pool, **kw))


# --- the groups: one a fixture file -------------------------------------------

@group
def engine(cases):
    from obj2voxel_tpu import engine as jeng
    import obj2voxel_tpu_torch as pt
    import test_torch_engine as t

    for shape, r, _ in t.CLOSED_FORMS:
        tris = t.shape_tris(shape)
        kw = dict(resolution=r, pair_tile=t.TILE)
        with op_by_op():
            out = voxel_arrays(jeng.voxelize_soup(
                jeng.TriangleSoup.from_vertices(tris), **kw))
        cases.add(f"{shape}_{r}", [tris], kw, out)
    arrays = t.soup_arrays(t._random_soup(pt.TriangleSoup))
    for s in (0, 1):
        kw = dict(resolution=64, pair_tile=t.TILE, strategy=s)
        cases.add(f"random_{s}", [*arrays, *t.BOUNDS], kw,
                  _voxelize(arrays, bounds=t.BOUNDS, **kw))


@group
def api(cases):
    """tests/test_torch_api.py and test_torch_api_textured.py: the JAX
    Instance and CLI, 2^12-slot passes, silent."""
    import obj2voxel_tpu as jo
    from obj2voxel_tpu import cli as jcli
    import test_torch_api as t
    import test_torch_api_textured as tt

    pair_tile = jo.constants.PAIR_TILE
    jo.constants.PAIR_TILE = t.PAIR_TILE
    jo.set_log_level(jo.constants.LOG_LEVEL_SILENT)
    try:
        _api_cases(cases, jo, jcli, t, tt)
    finally:
        jo.constants.PAIR_TILE = pair_tile
        jo.set_log_level(jo.constants.LOG_LEVEL_INFO)


def _api_cases(cases, jo, jcli, t, tt):
    def voxelize(inst):
        with op_by_op():
            return inst.voxelize()

    def both(case, inputs, configure, resolution, fmt="vl32", strategy=0):
        err, data = t._run(jo, t.configured(configure, fmt, strategy), resolution,
                           voxelize)
        cases.add(case, inputs, dict(resolution=resolution, fmt=fmt,
                                     strategy=strategy, pair_tile=t.PAIR_TILE),
                  {"err": err, "bytes": np.frombuffer(data, np.uint8)})

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        t.write_meshes(d)
        both("cube_obj", t.mesh_inputs(d, "cube.obj"), t.file_input(d, "cube.obj"), 32)
        both("binary_stl", t.mesh_inputs(d, "mesh.stl"), t.file_input(d, "mesh.stl"), 24)
        for s in (0, 1):
            both(f"callback_{s}", t.callback_arrays(), t.callback_input, 16, strategy=s)
        for fmt in t.FORMATS:
            both(f"tex_{fmt}", t.mesh_inputs(d, "tex.obj"), t.file_input(d, "tex.obj"),
                 20, fmt)
        for strategy in ("max", "blend"):
            fmt, args = tt.cli_args(strategy)
            out = d / f"j.{fmt}"
            with op_by_op():
                rc = jcli.main([str(d / "tex.obj"), str(out), *args])
            cases.add(f"cli_{strategy}", t.mesh_inputs(d, "tex.obj"),
                      dict(fmt=fmt, args=args),
                      {"rc": rc, "bytes": np.frombuffer(out.read_bytes(), np.uint8)})
    for case in t.ERROR_CASES:
        codes = t.error_codes(jo, case, voxelize)
        cases.add(f"errors_{case}", [t.BASIC_TRI], dict(case=case),
                  {"codes": [-1 if c is None else c for c in codes]})


@group
def batch(cases):
    from obj2voxel_tpu import engine as jeng
    from obj2voxel_tpu.ops.color import TexturePool
    import test_torch_batch as t

    meshes, texture = t._arrays()
    soups, pool = t._batch(jeng.TriangleSoup, TexturePool)
    for name, (r, ss, strategy) in t.CASES.items():
        with op_by_op():
            results = jeng.voxelize_batch(soups, pool, resolution=r, supersampling=ss,
                                          strategy=strategy, pair_tile=t.TILE)
        out = {}
        for i, res in enumerate(results):
            out.update(voxel_arrays([res], prefix=f"m{i}_"))
        cases.add(name, t.flat_arrays(meshes, texture),
                  dict(resolution=r, supersampling=ss, strategy=strategy,
                       pair_tile=t.TILE), out)


@group
def batched_pass(cases):
    """tests/test_torch_batched_pass.py: `_bucket_pass_batch`, its Pallas
    kernel in interpret mode (jitted)."""
    import jax.numpy as jnp
    from obj2voxel_tpu.engine import _bucket_pass_batch
    import test_torch_batched_pass as t

    expand, res, budget = t.JAX_PASS
    table_np, _, cols = t.jax_pass_inputs()
    keys, chans, counts = _bucket_pass_batch(
        jnp.asarray(np.ascontiguousarray(table_np.T)),
        *(jnp.asarray(c) for c in cols), jnp.int32(res),
        expand=expand, budget=budget, nbatch=t.B, use_pallas=False)
    out = {"keys": np.asarray(keys), "counts": np.asarray(counts)}
    out.update({f"chan{j}": np.asarray(c) for j, c in enumerate(chans)})
    cases.add("bucket_pass_batch", [table_np, *cols],
              dict(res=res, expand=expand, budget=budget, nbatch=t.B), out)


@group
def clip(cases):
    """tests/test_torch_clip.py: `clip_channels` and the plain XLA
    `_bucket_pass`, op by op."""
    import jax.numpy as jnp
    from obj2voxel_tpu import engine as jeng
    from obj2voxel_tpu.ops import clip as jclip
    import test_torch_clip as t

    for seed in (0, 1):
        tri, vox = t._clip_inputs(seed)
        w, u, v = (np.asarray(x) for x in jclip.clip_channels(jnp.asarray(tri),
                                                              jnp.asarray(vox)))
        cases.add(f"clip_channels_{seed}", [tri, vox], {}, {"w": w, "u": u, "v": v})

    def bucket_pass(case, table, budget, desc, z_lo, z_hi, stride):
        desc = tuple(int(x) for x in desc)
        expand, r0, n_rows, local_base, wide = desc
        padded = np.zeros((table.shape[0] + budget, 24), np.float32)
        padded[: table.shape[0]] = table
        with op_by_op():
            keys, chans, _, _, count = jeng._bucket_pass(
                jnp.asarray(padded.T), jnp.zeros((1,), jnp.uint32),
                jnp.zeros((1, 4), jnp.int32),
                jeng.pass_scalars(r0, n_rows, local_base, z_lo, z_hi, stride,
                                  False, False),
                expand=expand, budget=budget, use_pallas=False, wide_local=wide,
                finalize=False, fused=False)
        n = int(count)
        out = {"keys": np.asarray(keys)[:n]}
        out.update({f"chan{j}": np.asarray(c)[:n] for j, c in enumerate(chans)})
        cases.add(case, [table], dict(budget=budget, desc=desc, z_lo=z_lo,
                                      z_hi=z_hi, stride=stride), out)

    with tables_checked_against_jax(t):
        for name in t.PASS_DESCS:
            bucket_pass(name, *t.pass_case(name))
        for local_base in (0, 4096):
            bucket_pass(f"wide_local_{local_base}", *t.wide_local_case(local_base))


@group
def clip_pairs(cases):
    """tests/test_torch_clip_pairs.py: `clip_channels` and the jnp oracle
    op by op, `clip_pairs_pallas` in interpret mode."""
    import jax.numpy as jnp
    from obj2voxel_tpu.ops.clip import clip_channels, clip_triangles_to_voxels
    from obj2voxel_tpu.ops.clip_pallas import clip_pairs_pallas
    import test_torch_clip_pairs as t

    verts, uvs, vox, (tri, vox4) = t.make_inputs()
    with op_by_op():
        w, u, v = (np.asarray(x)[0] for x in clip_channels(jnp.asarray(tri),
                                                           jnp.asarray(vox4)))
    cases.add("clip_channels", [tri, vox4], {}, {"w": w, "u": u, "v": v})
    pos = vox.astype(np.int32)
    with op_by_op():
        w, uv = clip_triangles_to_voxels(jnp.asarray(verts), jnp.asarray(uvs),
                                         jnp.asarray(pos))
    cases.add("oracle", [verts, uvs, pos], {}, {"w": np.asarray(w), "uv": np.asarray(uv)})
    out = np.asarray(clip_pairs_pallas(jnp.asarray(tri), jnp.asarray(vox4),
                                       interpret=True))
    cases.add("pallas_interpret", [tri, vox4], {}, {"out": out})


@group
def combine(cases):
    """tests/test_torch_combine.py: the combine oracle (premultiply, stable
    sort, `combine_sorted`) and finalize-and-pack, eagerly, op by op."""
    import jax.numpy as jnp
    from obj2voxel_tpu.ops import combine as jcomb
    import test_torch_combine as t

    for name, ((keys, w, rgb), is_blend) in t.combined_cases().items():
        chans = jcomb.premultiply(jnp.asarray(w), jnp.asarray(rgb))
        sk, sch = jcomb.sort_channels(jnp.asarray(keys), chans)
        ok, och, oc = jcomb.combine_sorted(sk, sch, is_blend)
        oc = int(oc)
        cases.add(name, [keys, w, rgb], dict(is_blend=is_blend),
                  {"keys": np.asarray(ok)[:oc],
                   "vals": np.stack([np.asarray(c)[:oc] for c in och], -1)})
    w, rgb = t.finalize_inputs()
    jchans = jcomb.premultiply(jnp.asarray(w), jnp.asarray(rgb))
    cases.add("finalize_pack_argb", [w, rgb], {},
              {"argb": np.asarray(jcomb.pack_argb(jcomb.finalize_colors(jchans)))})


@group
def fused_textured(cases):
    """tests/test_torch_fused_textured.py: `fused_pass_pallas(textured=True)`
    in interpret mode; `clip_channels` and the triangle area op by op."""
    import jax.numpy as jnp
    from obj2voxel_tpu.ops import clip as jclip
    from obj2voxel_tpu.ops.pass_fused import fused_pass_pallas
    import test_torch_fused_textured as t

    with tables_checked_against_jax(t):
        rows = t._table(6, res=t.SMALL[2])[t.R0:t.R0 + t.N_ROWS]
        clip_table = t._table(5)
    out = fused_pass_pallas(
        jnp.asarray(rows.T), 0, t.SMALL[0], t.SMALL[2], t.SMALL[1], t.N_ROWS,
        expand=t.EXPAND, budget=t.BUDGET, textured=True, interpret=True)
    cases.add("pallas_interpret", [rows],
              dict(grid=t.SMALL, n_rows=t.N_ROWS, expand=t.EXPAND, budget=t.BUDGET),
              dict(zip(("key", "w", "u", "v", "zero"), map(np.asarray, out))))
    _, _, tri, vox4 = t.clip_inputs(clip_table)
    with op_by_op():
        w, u, v = (np.asarray(x)[0] for x in jclip.clip_channels(
            jnp.asarray(tri), jnp.asarray(vox4)))
        # obj2voxel_tpu/ops/pass_fused.py:191-197
        e = jnp.asarray(tri)
        e1x, e1y, e1z = e[3] - e[0], e[4] - e[1], e[5] - e[2]
        e2x, e2y, e2z = e[6] - e[0], e[7] - e[1], e[8] - e[2]
        cx = e1y * e2z - e1z * e2y
        cy = e1z * e2x - e1x * e2z
        cz = e1x * e2y - e1y * e2x
        area = np.asarray(0.5 * jnp.sqrt(cx * cx + cy * cy + cz * cz))
    cases.add("clip_channels", [tri, vox4], {}, {"w": w, "u": u, "v": v, "area": area})


@group
def helpers(cases):
    """tests/test_torch_helpers.py: `clip_triangles_to_voxels` and
    `sample_pair_colors`, op by op."""
    import jax.numpy as jnp
    from obj2voxel_tpu.ops import clip as jclip
    from obj2voxel_tpu.ops import color as jcolor
    import test_torch_helpers as t

    for seed in (0, 1):
        verts, uvs, pos = t._pairs(seed)
        with op_by_op():
            w, uv = jclip.clip_triangles_to_voxels(
                jnp.asarray(verts), jnp.asarray(uvs), jnp.asarray(pos))
        cases.add(f"clip_{seed}", [verts, uvs, pos], {},
                  {"w": np.asarray(w), "uv": np.asarray(uv)})
    for seed in (0, 1):
        textures, images, uv, types, rgb, tex = t._color_inputs(seed)
        wraps = [int(x[2]) for x in textures]
        pixels, meta = _jax_pool(list(zip(images, wraps))).device_arrays()
        with op_by_op():
            want = np.asarray(jcolor.sample_pair_colors(
                jnp.asarray(uv), jnp.asarray(types), jnp.asarray(rgb),
                jnp.asarray(tex), jnp.asarray(pixels), jnp.asarray(meta)))
        cases.add(f"colors_{seed}", t.color_arrays(seed), dict(wraps=wraps),
                  {"rgb": want})


@group
def merge_runs(cases):
    """tests/test_torch_merge_runs.py: `merge_runs_pallas` in interpret mode
    (jitted) and the cube's `voxelize_soup` op by op."""
    import jax.numpy as jnp
    from obj2voxel_tpu import engine as jeng
    from obj2voxel_tpu.ops import merge_pallas as jmerge
    from obj2voxel_tpu_torch.ops.merge_pallas import plan_runs
    import test_torch_merge_runs as t

    keys, chans, counts, n_block = t.kernel_case()
    # the JAX buffer pads each run to the block with INVALID rows
    aligned, levels, spad = jmerge.plan_runs(counts, n_block)
    p = aligned[-1]
    pb = p + (n_block // 128 + jmerge._WIN_PAD) * 128
    jk = np.full(pb, t.INV, np.int32)
    jc = [np.zeros(pb, np.float32) for _ in range(4)]
    dense, _ = plan_runs(counts)
    for i, c in enumerate(counts):
        jk[aligned[i]:aligned[i] + c] = keys[dense[i]:dense[i + 1]]
        for a, b in zip(jc, chans):
            a[aligned[i]:aligned[i] + c] = b[dense[i]:dense[i + 1]]
    aoff = np.asarray(aligned + [p] * (spad + 1 - len(aligned)), np.int32)
    ok, oc = jmerge.merge_runs_pallas(
        jnp.asarray(jk), tuple(jnp.asarray(c) for c in jc), jnp.asarray(aoff),
        p=p, n_block=n_block, levels=levels, spad=spad, interpret=True)
    n = keys.size
    out = {"keys": np.asarray(ok)[:n]}
    out.update({f"chan{j}": np.asarray(c)[:n] for j, c in enumerate(oc)})
    cases.add("kernel", [keys, *chans], dict(counts=counts, n_block=n_block), out)

    from conftest import UNIT_CUBE_QUADS, UNIT_CUBE_VERTICES, quads_to_tris

    cube = quads_to_tris(UNIT_CUBE_VERTICES, UNIT_CUBE_QUADS)
    with op_by_op():
        out = voxel_arrays(jeng.voxelize_soup(jeng.TriangleSoup.from_vertices(cube),
                                              **t.JAX_CUBE))
    cases.add("cube", [cube], t.JAX_CUBE, out)


@group
def parallel(cases):
    """tests/test_torch_parallel.py: `voxelize_sharded(n_devices=3)`
    jitted on the CPU's virtual devices."""
    from obj2voxel_tpu.engine import TriangleSoup
    from obj2voxel_tpu.parallel import mesh as jmesh
    import test_torch_parallel as t

    xyz, argb = jmesh.voxelize_sharded(TriangleSoup.from_vertices(t.CUBE),
                                       n_devices=3, **t.SHARDED)
    cases.add("cube_sharded", [t.CUBE], dict(n_devices=3, **t.SHARDED),
              voxel_arrays([(xyz, argb)]))


@group
def supersampling(cases):
    """tests/test_torch_supersampling.py: `voxelize_soup` and
    `voxelize_grid`, op by op."""
    import jax.numpy as jnp
    from obj2voxel_tpu import engine as jeng
    import obj2voxel_tpu_torch as pt
    import test_torch_supersampling as t
    import test_torch_textures as tt

    with op_by_op():
        out = voxel_arrays(jeng.voxelize_soup(jeng.TriangleSoup.from_vertices(t.CUBE),
                                              **t.CUBE_KW))
    cases.add("cube", [t.CUBE], t.CUBE_KW, out)
    arrays = t.soup_arrays(t._one_voxel_soup(pt.TriangleSoup, 3000, 64, seed=1))
    for s in (0, 1):
        kw = dict(strategy=s, **t.SEEDED_KW)
        cases.add(f"seeded_{s}", [*arrays, *t.BOUNDS], kw,
                  _voxelize(arrays, bounds=t.BOUNDS, **kw))
    for budget in (t.TILE, 1):
        arrays, kw = t.tie_grid_inputs(budget)
        pixels, meta = _jax_pool([]).device_arrays()
        with op_by_op():
            out = voxel_arrays(jeng.voxelize_grid(*arrays, jnp.asarray(pixels),
                                                  jnp.asarray(meta), **kw))
        cases.add(f"tie_{budget}", arrays, kw, out)
    arrays, textures = t.textured_inputs()
    cases.add("textured", [*arrays, *t.BOUNDS, *tt.texture_arrays(textures)],
              t.TEXTURED_KW, _voxelize(arrays, _jax_pool(textures), bounds=t.BOUNDS,
                                       **t.TEXTURED_KW))


@group
def textures(cases):
    """tests/test_torch_textures.py and test_torch_textures_multipass.py:
    `voxelize_soup`, op by op."""
    import test_torch_textures as t

    for case in t.TEXTURES_CASES:
        arrays, textures, kw = t.textures_case(case)
        cases.add(case, [*arrays, *t.texture_arrays(textures), *t.BOUNDS], kw,
                  _voxelize(arrays, _jax_pool(textures), bounds=t.BOUNDS, **kw))


@group
def weights(cases):
    """tests/test_torch_weights.py: `voxelize_soup` under
    O2V_WEIGHT_MODE=input_area, op by op."""
    import test_torch_textures as tt
    import test_torch_weights as t

    old = os.environ.get("O2V_WEIGHT_MODE")
    os.environ["O2V_WEIGHT_MODE"] = "input_area"
    try:
        for case in t.WEIGHTS_CASES:
            arrays, textures, kw = t.weights_case(case)
            pool = _jax_pool(textures) if textures else None
            cases.add(case, [*arrays, *(tt.texture_arrays(textures) if textures else []),
                             *t.BOUNDS], dict(weight_mode="input_area", **kw),
                      _voxelize(arrays, pool, bounds=t.BOUNDS, **kw))
    finally:
        if old is None:
            del os.environ["O2V_WEIGHT_MODE"]
        else:
            os.environ["O2V_WEIGHT_MODE"] = old


def main(argv):
    names = argv or list(GROUPS)
    unknown = [n for n in names if n not in GROUPS]
    if unknown:
        raise SystemExit(f"unknown group(s) {unknown}; groups: {list(GROUPS)}")
    import conftest  # noqa: F401  (pins JAX to the CPU, 8 virtual devices)

    for name in names:
        cases = Cases(name)
        GROUPS[name](cases)
        cases.write()


if __name__ == "__main__":
    main(sys.argv[1:])
