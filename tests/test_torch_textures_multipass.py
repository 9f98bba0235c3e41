"""Textured meshes over several slabs of several passes:
obj2voxel_tpu_torch.voxelize_soup(device="cpu") against
obj2voxel_tpu.engine.voxelize_soup, under the parity contract of
test_torch_textures.py (a file of its own so that each file's op-by-op
reference stays within a minute)."""

import pytest
import torch

from obj2voxel_tpu import constants as C
from test_torch_textures import check_random_soup, pass_log  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("strategy", [C.MAX_STRATEGY, C.BLEND_STRATEGY],
                         ids=["max", "blend"])
def test_random_textured_soup_multi_pass_matches_jax(pass_log, strategy):  # noqa: F811
    # triangles of one AABB size, 7 voxels a side: one bucket, so few
    # distinct pass shapes for the op-by-op reference to compile, and few
    # live pairs per slab, so every slab's merge has the same padded size
    port = check_random_soup(pass_log, strategy, n=60, r=32, spread=3.0,
                             fixed=True)
    slabs = {z for z, _, _ in pass_log}
    assert 1 < len(slabs) < len(pass_log)
    assert len(port) > 1500
