"""Textured meshes over several slabs of several passes:
obj2voxel_tpu_torch.voxelize_soup(device="cpu") against
obj2voxel_tpu.engine.voxelize_soup (tests/fixtures/jax_textures.npz), under
the parity contract of test_torch_textures.py."""

import pytest
import torch

from obj2voxel_tpu_torch import constants as C
from test_torch_textures import check_random_soup, pass_log  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("strategy", [C.MAX_STRATEGY, C.BLEND_STRATEGY],
                         ids=["max", "blend"])
def test_random_textured_soup_multi_pass_matches_jax(pass_log, strategy):  # noqa: F811
    # triangles of one AABB size, 7 voxels a side: one bucket, several
    # slabs of several passes
    port = check_random_soup(pass_log, strategy, "multi_pass")
    slabs = {z for z, _, _ in pass_log}
    assert 1 < len(slabs) < len(pass_log)
    assert len(port) > 1500
