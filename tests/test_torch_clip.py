"""The port's clip and K1 plain version against the JAX package on the CPU.

Same numpy inputs through `obj2voxel_tpu` (JAX, plain XLA path, its
outputs held in tests/fixtures/jax_clip.npz by scripts/jax_test_references.py)
and `obj2voxel_tpu_torch` (plain PyTorch versions).  Weights are held to
rtol 1e-6; keys, counts and order exactly.
"""

import numpy as np
import pytest
import torch

from jax_reference import reference
from obj2voxel_tpu_torch.ops import clip as tclip
from obj2voxel_tpu_torch.ops.pass_fused import fused_pass, fused_pass_ref
from obj2voxel_tpu_torch.soup import build_tri_table

torch.set_num_threads(1)


def _clip_inputs(seed, p=3000):
    rng = np.random.default_rng(seed)
    vox = rng.integers(0, 8, size=(3, p)).astype(np.float32)
    verts = vox.T[:, None, :] + rng.uniform(-0.7, 1.7, size=(p, 3, 3))
    # a quarter of the vertices on exact voxel planes (the epsilon rules)
    snap = rng.random((p, 3, 3)) < 0.25
    verts = np.where(snap, np.round(verts), verts).astype(np.float32)
    uvs = rng.random((p, 3, 2), dtype=np.float32)
    tri = np.zeros((16, p), np.float32)
    tri[0:9] = verts.reshape(p, 9).T
    tri[9:15] = uvs.reshape(p, 6).T
    vox4 = np.zeros((4, p), np.float32)
    vox4[:3] = vox
    return tri, vox4


@pytest.mark.parametrize("seed", [0, 1])
def test_clip_channels_matches_jax(seed):
    tri, vox = _clip_inputs(seed)
    ref = reference("clip", f"clip_channels_{seed}", tri, vox)
    jw, ju, jv = ref["w"], ref["u"], ref["v"]
    tw, tu, tv = (x.numpy() for x in tclip.clip_channels(torch.from_numpy(tri), torch.from_numpy(vox)))
    assert (jw > 0).sum() > 100
    np.testing.assert_array_equal(tw > 0, jw > 0)
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tu, ju, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-7)


def _pass_table(seed, n=600, res=32):
    """Random triangles of mixed sizes in voxel space, as the (N, 24) table."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, res - 4, size=(n, 1, 3))
    size = rng.choice([0.8, 2.5, 5.0], size=(n, 1, 1))
    verts = (base + rng.uniform(0, 1, size=(n, 3, 3)) * size).astype(np.float32)
    table = build_tri_table(
        verts, np.zeros((n, 3, 2), np.float32), np.full(n, 2, np.int32),
        rng.random((n, 3), dtype=np.float32), np.full(n, -1, np.int32),
    )
    return table


def _jax_pass(case, table, budget, desc, z_lo, z_hi, stride):
    """The JAX package's `_bucket_pass` (plain XLA path, op by op: a jitted
    XLA CPU program contracts multiply-adds into FMAs, which the port and
    its CUDA kernel, built with --fmad=false, do not): the live keys and
    four channels, key-sorted."""
    desc = tuple(int(x) for x in desc)
    ref = reference("clip", case, table, budget=budget, desc=desc, z_lo=z_lo,
                    z_hi=z_hi, stride=stride)
    return ref["keys"], [ref[f"chan{j}"] for j in range(4)]


def _port_pass_sorted(table, budget, desc, z_lo, z_hi, stride):
    expand, r0, n_rows, local_base, wide = desc
    out = fused_pass(torch.from_numpy(table), r0, n_rows, local_base, z_lo,
                     z_hi, stride, expand=expand, budget=budget,
                     wide_local=wide)
    n = int(out[5])
    keys = out[0][:n]
    # the kernel keeps slot order; the JAX compact tail is key-sorted
    # (stably), so a stable key sort makes the two comparable
    sk, idx = torch.sort(keys, stable=True)
    assert bool((out[0][n:] == (1 << 31) - 1).all())
    return sk.numpy(), [c[:n][idx].numpy() for c in out[1:5]]


PASS_DESCS = {
    "expand1": (1, 0, 600, 0, False),
    "expand8": (8, 10, 500, 0, False),
    "expand64": (64, 0, 64, 0, False),
    "expand64-tail": (64, 500, 64, 0, False),  # overread past the table's end is dead
}


def pass_case(name):
    """(table, budget, desc, z_lo, z_hi, stride) of a `PASS_DESCS` case."""
    desc = PASS_DESCS[name]
    table = _pass_table(3)
    budget, z_lo, z_hi, stride = 4096, 2, 30, 32
    if desc[0] * desc[2] > budget:
        desc = (desc[0], desc[1], budget // desc[0], desc[3], desc[4])
    desc = (desc[0], desc[1], min(desc[2], table.shape[0] - desc[1]), desc[3], desc[4])
    return table, budget, desc, z_lo, z_hi, stride


def wide_local_case(local_base):
    """One giant slanted triangle: AABB 64 x 64 x 3 = 12288 slots > budget."""
    table = np.zeros((1, 24), np.float32)
    table[0, 0:9] = [0.5, 0.5, 0.5, 63.5, 0.5, 2.5, 0.5, 63.5, 2.5]
    table[0, 17:20] = [0.1, 0.5, 0.9]
    return table, 4096, (4096, 0, 1, local_base, True), 0, 64, 64


@pytest.mark.parametrize("name", list(PASS_DESCS))
def test_fused_pass_plain_matches_jax(name):
    table, budget, desc, z_lo, z_hi, stride = pass_case(name)
    jk, jc = _jax_pass(name, table, budget, desc, z_lo, z_hi, stride)
    tk, tc = _port_pass_sorted(table, budget, desc, z_lo, z_hi, stride)
    assert jk.size > 100
    np.testing.assert_array_equal(tk, jk)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("local_base", [0, 4096])
def test_fused_pass_plain_wide_local_matches_jax(local_base):
    case = wide_local_case(local_base)
    jk, jc = _jax_pass(f"wide_local_{local_base}", *case)
    tk, tc = _port_pass_sorted(*case)
    assert jk.size > 100
    np.testing.assert_array_equal(tk, jk)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_fused_pass_wrapper_uses_plain_version_on_cpu():
    table = torch.from_numpy(_pass_table(4))
    args = (table, 0, 100, 0, 0, 32, 32)
    got = fused_pass(*args, expand=8, budget=1024)
    want = fused_pass_ref(*args, expand=8, budget=1024, wide_local=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "kw",
    [
        dict(expand=3, budget=1024),  # not a power of two
        dict(expand=8, budget=100),  # budget not a multiple of expand
        dict(expand=1, budget=64),  # more rows than the budget holds
    ],
)
def test_fused_pass_rejects_bad_shapes(kw):
    table = torch.from_numpy(_pass_table(5))
    with pytest.raises(ValueError):
        fused_pass(table, 0, 100, 0, 0, 32, 32, **kw)
