"""The port's Instance and CLI against the JAX package's on a seeded OBJ
textured by a PNG, in every output format, under the parity contract and
with the inputs of test_torch_api.py; the JAX outputs are those of
tests/fixtures/jax_api.npz."""

import pytest

from jax_reference import reference
from obj2voxel_tpu_torch import cli as pcli
from test_torch_api import (  # noqa: F401
    FORMATS, _assert_blend_parity, _both, _quiet_small_passes, _vl32, file_input,
    files, mesh_inputs,
)


@pytest.mark.parametrize("fmt", FORMATS)
def test_png_textured_obj_matches_jax_in_every_format(files, fmt):
    data = _both(f"tex_{fmt}", mesh_inputs(files, "tex.obj"),
                 file_input(files, "tex.obj"), 20, fmt)
    assert len(data) > 100
    if fmt == "vl32":
        # texels of the PNG and the flat material both reached the output
        assert len(set(_vl32(data)[:, 3].tolist())) > 10


def cli_args(strategy):
    """The CLI's output format and arguments of each strategy's case."""
    fmt = "ply" if strategy == "max" else "vl32"
    return fmt, ["-r", "20", "-s", strategy, "-p", "xZy", "-j", "0"]


@pytest.mark.parametrize("strategy", ["max", "blend"])
def test_cli_matches_jax(files, tmp_path, strategy):
    src = str(files / "tex.obj")
    fmt, args = cli_args(strategy)
    pout = tmp_path / f"p.{fmt}"
    assert pcli.main([src, str(pout), *args, "--device", "cpu"]) == 0
    ref = reference("api", f"cli_{strategy}", *mesh_inputs(files, "tex.obj"),
                    fmt=fmt, args=args)
    assert int(ref["rc"]) == 0
    jout = ref["bytes"].tobytes()
    if strategy == "max":
        assert pout.read_bytes() == jout
    else:
        _assert_blend_parity(pout.read_bytes(), jout)
