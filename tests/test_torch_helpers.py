"""The port's public op helpers against the JAX package's on the CPU:
Morton codes (`ops/morton.py`), the per-pair clip (`ops/clip.py`
`clip_triangles_to_voxels` and its K4 twin `ops/clip_pallas.py`
`clip_triangles_to_voxels_pallas`) and `ops/color.sample_pair_colors`.

Every comparison is exact: the clip's inputs are test_torch_clip.py's pairs
(a quarter of the vertices on voxel planes), and the JAX clip ran op by op,
with no multiply-add contraction, like the port.  The JAX clip's and color
sampler's outputs are those of tests/fixtures/jax_helpers.npz
(scripts/jax_test_references.py); the Morton codes run live.
"""

import numpy as np
import pytest
import torch

from jax_reference import reference
from obj2voxel_tpu.ops import morton as jmorton
import obj2voxel_tpu_torch as pt
from obj2voxel_tpu_torch import constants as C
from obj2voxel_tpu_torch.ops import clip as tclip
from obj2voxel_tpu_torch.ops import clip_pallas as tclip_pallas
from obj2voxel_tpu_torch.ops import color as tcolor
from obj2voxel_tpu_torch.ops import morton as tmorton
from test_torch_clip import _clip_inputs

torch.set_num_threads(1)


def _coords(seed, n=4096):
    """Random 21-bit coordinates, plus the edges 0, 1 and 2^21 - 1."""
    rng = np.random.default_rng(seed)
    xyz = rng.integers(0, 1 << 21, size=(3, n), dtype=np.int64)
    edges = np.array([0, 1, (1 << 21) - 1, 1 << 20, (1 << 20) - 1], np.int64)
    grid = np.stack(np.meshgrid(edges, edges, edges, indexing="ij")).reshape(3, -1)
    return np.concatenate([xyz, grid], axis=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_morton_matches_jax(seed):
    x, y, z = _coords(seed)
    # the JAX module on int64 numpy arrays (jnp arrays are int32 here)
    want = jmorton.ileave3(x, y, z)
    got = tmorton.ileave3(*(torch.from_numpy(a) for a in (x, y, z)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmorton.ileave3(x, y, z), want)  # numpy in
    for got_axis, want_axis, axis in zip(tmorton.dileave3(got),
                                         jmorton.dileave3(want), (x, y, z)):
        np.testing.assert_array_equal(got_axis.numpy(), want_axis)
        np.testing.assert_array_equal(got_axis.numpy(), axis)


def test_morton_orders_a_block_contiguously():
    codes = sorted(int(tmorton.ileave3(x, y, z))
                   for x in range(2) for y in range(2) for z in range(2))
    assert codes == list(range(8))
    assert int(tmorton.ileave3(1, 0, 0)) == 4  # x in the highest lane


def _pairs(seed):
    tri, vox = _clip_inputs(seed)
    p = tri.shape[1]
    verts = tri[0:9].T.reshape(p, 3, 3).copy()
    uvs = tri[9:15].T.reshape(p, 3, 2).copy()
    return verts, uvs, vox[:3].T.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("helper", ["clip", "clip_pallas"])
def test_clip_triangles_to_voxels_matches_jax(seed, helper):
    verts, uvs, pos = _pairs(seed)
    ref = reference("helpers", f"clip_{seed}", verts, uvs, pos)
    jw, juv = ref["w"], ref["uv"]
    args = [torch.from_numpy(a) for a in (verts, uvs, pos)]
    fn = (tclip.clip_triangles_to_voxels if helper == "clip"
          else tclip_pallas.clip_triangles_to_voxels_pallas)
    tw, tuv = fn(*args)
    assert tw.dtype == tuv.dtype == torch.float32
    assert tw.shape == (verts.shape[0],) and tuv.shape == (verts.shape[0], 2)
    assert (np.asarray(jw) > 0).sum() > 100
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))


def color_arrays(seed):
    """The color case's input arrays: each texture's pixels, then uv,
    types, rgb and tex."""
    textures, images, uv, types, rgb, tex = _color_inputs(seed)
    return [*images, uv, types, rgb, tex]


def _color_inputs(seed, n=5000):
    rng = np.random.default_rng(seed)
    textures = [(3, 5, C.UV_CLAMP), (16, 7, C.UV_WRAP), (1, 9, C.UV_WRAP),
                (33, 2, C.UV_CLAMP)]
    images = [(0xFF000000 | rng.integers(0, 1 << 24, (h, w))).astype(np.uint32)
              for h, w, _ in textures]
    uv = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    uv[:64] = np.round(uv[:64] * 4) / 4  # texel edges
    types = rng.choice([C.TRI_MATERIALLESS, C.TRI_UNTEXTURED, C.TRI_TEXTURED],
                       size=n).astype(np.int32)
    rgb = rng.random((n, 3), dtype=np.float32)
    tex = rng.integers(-1, len(textures), n).astype(np.int32)
    return textures, images, uv, types, rgb, tex


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_pair_colors_matches_jax(seed):
    textures, images, uv, types, rgb, tex = _color_inputs(seed)
    tpool = pt.TexturePool()
    for img, (_, _, wrap) in zip(images, textures):
        tpool.add(img, wrap)
    want = reference("helpers", f"colors_{seed}", *color_arrays(seed),
                     wraps=[int(t[2]) for t in textures])["rgb"]
    got = tcolor.sample_pair_colors(
        torch.from_numpy(uv), torch.from_numpy(types).to(torch.int64),
        torch.from_numpy(rgb), torch.from_numpy(tex).to(torch.int64),
        *tcolor.upload_pool(tpool, "cpu"))
    assert got.shape == (uv.shape[0], 3)
    np.testing.assert_array_equal(got.numpy(), want)
    sampled = (types == C.TRI_TEXTURED) & (tex >= 0)
    assert sampled.sum() > 1000
