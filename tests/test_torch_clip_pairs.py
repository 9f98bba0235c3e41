"""K4's plain version (`clip_pairs` on CPU tensors) against the JAX package's
standalone clip: the Pallas kernel `clip_pairs_pallas` in interpret mode,
the kernel body's channel-major clip `clip_channels`, and the jnp oracle
`clip_triangles_to_voxels`.

Tolerances:
- against `clip_channels` and `clip_triangles_to_voxels` run op by op
  (`jax.disable_jit()`), the same float32 operations in the same order:
  w, u and v exactly;
- against the interpret-mode kernel, which XLA compiles for the CPU and
  contracts multiply-adds into FMAs: the same occupancy above 1e-6, w to
  rtol 1e-5 with atol 1e-6 for knife-edge slivers (one weight of these 5000
  moves by 2.7e-6 relative), u and v on occupied pairs to rtol 1e-5 with
  atol 1e-4 (the contracted edge-plane intersections move UVs of up to 3 in
  magnitude by up to 3.4e-5 on four of these pairs).

tests/fixtures/jax_clip_pairs.npz holds the three JAX outputs
(scripts/jax_test_references.py).
"""

import numpy as np
import pytest
import torch

from jax_reference import reference
from obj2voxel_tpu_torch.ops.clip_pallas import clip_pairs, clip_pairs_ref

torch.set_num_threads(1)


def _pairs(seed, p):
    """Voxel-local triangles, a quarter of their coordinates snapped onto
    voxel planes (the epsilon rules), with UVs in [-2, 3]."""
    rng = np.random.default_rng(seed)
    vox = rng.integers(0, 8, size=(p, 3)).astype(np.float32)
    verts = vox[:, None, :] + rng.uniform(-0.7, 1.7, size=(p, 3, 3))
    snap = rng.random((p, 3, 3)) < 0.25
    verts = np.where(snap, np.round(verts), verts).astype(np.float32)
    uvs = rng.uniform(-2, 3, size=(p, 3, 2)).astype(np.float32)
    return verts, uvs, vox


def _grazing(seed, p):
    """Triangles in or within 1e-5 of a voxel face, and triangles whose
    plane lies exactly on a face: the pairs whose clipped area is a sliver
    or zero depending on the epsilon tests."""
    rng = np.random.default_rng(seed)
    vox = rng.integers(0, 8, size=(p, 3)).astype(np.float32)
    verts = vox[:, None, :] + rng.uniform(0, 1, size=(p, 3, 3))
    axis = rng.integers(0, 3, size=p)
    offset = rng.choice([0.0, 1.0, 1e-5, -1e-5, 1 + 1e-5, 1 - 1e-5, 2 ** -16],
                        size=p)
    verts[np.arange(p), :, axis] = (vox[np.arange(p), axis] + offset)[:, None]
    uvs = rng.uniform(-2, 3, size=(p, 3, 2)).astype(np.float32)
    return verts.astype(np.float32), uvs, vox


def _channels(verts, uvs, vox):
    p = verts.shape[0]
    tri = np.zeros((16, p), np.float32)
    tri[0:9] = verts.reshape(p, 9).T
    tri[9:15] = uvs.reshape(p, 6).T
    vox4 = np.zeros((4, p), np.float32)
    vox4[:3] = vox.T
    return tri, vox4


def make_inputs():
    """(verts, uvs, vox, (tri, vox4)) of 3000 random and 2000 grazing pairs."""
    parts = [_pairs(0, 3000), _grazing(1, 2000)]
    verts, uvs, vox = (np.concatenate(x) for x in zip(*parts))
    return verts, uvs, vox, _channels(verts, uvs, vox)


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module")
def port_out(inputs):
    tri, vox4 = inputs[3]
    return clip_pairs(torch.from_numpy(tri), torch.from_numpy(vox4)).numpy()


def test_plain_matches_clip_channels_exactly(inputs, port_out):
    tri, vox4 = inputs[3]
    ref = reference("clip_pairs", "clip_channels", tri, vox4)
    w, u, v = ref["w"], ref["u"], ref["v"]
    assert (w > 0).sum() > 1000 and (w == 0).sum() > 500
    np.testing.assert_array_equal(port_out[0], w)
    np.testing.assert_array_equal(port_out[1], u)
    np.testing.assert_array_equal(port_out[2], v)
    np.testing.assert_array_equal(port_out[3], 0.0)


def test_plain_matches_jnp_oracle(inputs, port_out):
    verts, uvs, vox, _ = inputs
    ref = reference("clip_pairs", "oracle", verts, uvs, vox.astype(np.int32))
    np.testing.assert_array_equal(port_out[0], ref["w"])
    np.testing.assert_array_equal(port_out[1:3].T, ref["uv"])


def test_plain_matches_pallas_interpret(inputs, port_out):
    tri, vox4 = inputs[3]
    want = reference("clip_pairs", "pallas_interpret", tri, vox4)["out"]
    assert want.shape == port_out.shape == (4, tri.shape[1])
    occupied = want[0] > 1e-6
    np.testing.assert_array_equal(port_out[0] > 1e-6, occupied)
    np.testing.assert_allclose(port_out[0], want[0], rtol=1e-5, atol=1e-6)
    for c in (1, 2):
        np.testing.assert_allclose(port_out[c][occupied], want[c][occupied],
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(want[3], 0.0)


@pytest.mark.parametrize("p", [0, 1, 257])
def test_any_length(p):
    tri, vox4 = _channels(*_pairs(5, p))
    got = clip_pairs(torch.from_numpy(tri), torch.from_numpy(vox4))
    assert got.shape == (4, p) and got.dtype == torch.float32
    assert torch.equal(got, clip_pairs_ref(torch.from_numpy(tri), torch.from_numpy(vox4)))


def test_boundary_plane_belongs_to_hi_voxel():
    # a triangle in the plane x = 6 lies in voxel x = 6, not x = 5
    verts = np.array([[[6.0, 5.2, 5.2], [6.0, 5.8, 5.2], [6.0, 5.2, 5.8]]] * 2,
                     np.float32)
    uvs = np.array([[[0.1, 0.2], [0.4, 0.2], [0.1, 0.6]]] * 2, np.float32)
    vox = np.array([[6, 5, 5], [5, 5, 5]], np.float32)
    tri, vox4 = _channels(verts, uvs, vox)
    out = clip_pairs(torch.from_numpy(tri), torch.from_numpy(vox4)).numpy()
    assert out[0, 0] == pytest.approx(0.5 * 0.6 * 0.6, rel=1e-5)
    assert out[1, 0] == pytest.approx(0.2, rel=1e-5)  # centroid u
    assert out[2, 0] == pytest.approx(1.0 / 3.0, rel=1e-5)  # centroid v
    assert out[0, 1] == 0.0 and out[1, 1] == 0.0 and out[2, 1] == 0.0


@pytest.mark.parametrize("bad", ["rows", "dtype", "length"])
def test_rejects_bad_inputs(bad):
    tri = torch.zeros((16, 8))
    vox = torch.zeros((4, 8))
    if bad == "rows":
        tri = torch.zeros((15, 8))
    elif bad == "dtype":
        vox = vox.to(torch.float64)
    else:
        vox = torch.zeros((4, 9))
    with pytest.raises(ValueError):
        clip_pairs(tri, vox)


def test_refuses_devices_without_kernel():
    with pytest.raises(ValueError, match="unsupported device meta"):
        clip_pairs(torch.zeros((16, 8), device="meta"),
                   torch.zeros((4, 8), device="meta"))
