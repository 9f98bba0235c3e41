"""The port's Instance and CLI against the JAX package's on a seeded OBJ
textured by a PNG, in every output format, under the parity contract and
with the inputs of test_torch_api.py (a file of its own so that each file's
op-by-op reference stays within a minute)."""

import jax
import pytest

from obj2voxel_tpu import cli as jcli
from obj2voxel_tpu_torch import cli as pcli
from test_torch_api import (  # noqa: F401
    FORMATS, _assert_blend_parity, _both, _quiet_small_passes, _vl32, files,
)


@pytest.mark.parametrize("fmt", FORMATS)
def test_png_textured_obj_matches_jax_in_every_format(files, fmt):
    data = _both(lambda i, _: i.set_input_file(str(files / "tex.obj")), 20, fmt)
    assert len(data) > 100
    if fmt == "vl32":
        # texels of the PNG and the flat material both reached the output
        assert len(set(_vl32(data)[:, 3].tolist())) > 10


@pytest.mark.parametrize("strategy", ["max", "blend"])
def test_cli_matches_jax(files, tmp_path, strategy):
    src = str(files / "tex.obj")
    fmt = "ply" if strategy == "max" else "vl32"
    jout, pout = tmp_path / f"j.{fmt}", tmp_path / f"p.{fmt}"
    args = ["-r", "20", "-s", strategy, "-p", "xZy", "-j", "0"]
    with jax.disable_jit():
        assert jcli.main([src, str(jout), *args]) == 0
    assert pcli.main([src, str(pout), *args, "--device", "cpu"]) == 0
    if strategy == "max":
        assert pout.read_bytes() == jout.read_bytes()
    else:
        _assert_blend_parity(pout.read_bytes(), jout.read_bytes())
