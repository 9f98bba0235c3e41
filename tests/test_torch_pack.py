"""K3's and K5's plain versions against the JAX package's pack oracles,
exactly."""

import numpy as np
import pytest
import torch

from obj2voxel_tpu.ops.pack_pallas import pack_channels_ref as jax_pack_channels_ref
from obj2voxel_tpu.ops.pack_pallas import pack_exact_ref as jax_pack_exact_ref
from obj2voxel_tpu_torch.ops.pack_pallas import (
    pack_channels, pack_channels_ref, pack_exact, pack_exact_ref,
)

torch.set_num_threads(1)

INV = (1 << 31) - 1


def _stream(seed, p, frac):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 30, p).astype(np.int32)
    keys[rng.random(p) >= frac] = INV
    vals = tuple(rng.random(p, dtype=np.float32) for _ in range(4))
    return keys, vals


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.25, 0.9, 1.0])
@pytest.mark.parametrize("p", [1, 1000, 8192 * 2])
def test_pack_exact_plain_matches_jax(p, frac):
    keys, vals = _stream(int(frac * 100) + p, p, frac)
    wk, wv, wn = jax_pack_exact_ref(keys, vals)
    gk, gv, gn = pack_exact_ref(torch.from_numpy(keys),
                                tuple(torch.from_numpy(v) for v in vals))
    assert int(gn) == wn and gn.dtype == torch.int32
    np.testing.assert_array_equal(gk.numpy(), wk)
    for a, b in zip(gv, wv):
        np.testing.assert_array_equal(a.numpy(), b)


def test_pack_exact_wrapper_uses_plain_version_on_cpu():
    keys, vals = _stream(3, 5000, 0.4)
    args = (torch.from_numpy(keys), tuple(torch.from_numpy(v) for v in vals))
    for a, b in zip(pack_exact(*args), pack_exact_ref(*args)):
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b)


def test_pack_exact_keeps_input_order():
    keys = np.array([INV, 5, INV, 5, 2, INV, 9], np.int32)
    vals = tuple(np.arange(7, dtype=np.float32) + j for j in range(4))
    k, v, n = pack_exact(torch.from_numpy(keys), tuple(torch.from_numpy(x) for x in vals))
    assert int(n) == 4
    np.testing.assert_array_equal(k.numpy(), [5, 5, 2, 9, INV, INV, INV])
    np.testing.assert_array_equal(v[0].numpy(), [1, 3, 4, 6, 0, 0, 0])


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.25, 0.9, 1.0])
@pytest.mark.parametrize("blocks", [1, 3])
def test_pack_channels_plain_matches_jax(blocks, frac):
    keys, vals = _stream(int(frac * 100) + blocks, 8192 * blocks, frac)
    wk, wv, wn = jax_pack_channels_ref(keys, vals)
    gk, gv, gn = pack_channels(torch.from_numpy(keys),
                               tuple(torch.from_numpy(v) for v in vals))
    assert int(gn) == wn and gn.dtype == torch.int32 and wn % 128 == 0
    np.testing.assert_array_equal(gk.numpy(), wk)
    for a, b in zip(gv, wv):
        np.testing.assert_array_equal(a.numpy(), b)


def test_pack_channels_block_layout():
    # block 0: 3 live rows -> rows [0, 3), fillers to 128; block 1: 130 live
    # rows -> rows [128, 258), fillers to 384; block 2: none
    keys = np.full(3 * 8192, INV, np.int32)
    keys[[5, 100, 8000]] = [7, 8, 9]
    keys[8192 + np.arange(130) * 7] = np.arange(130)
    vals = tuple(np.arange(keys.size, dtype=np.float32) + j for j in range(4))
    k, v, n = pack_channels_ref(torch.from_numpy(keys),
                                tuple(torch.from_numpy(x) for x in vals))
    assert int(n) == 384
    k = k.numpy()
    np.testing.assert_array_equal(k[:3], [7, 8, 9])
    assert (k[3:128] == INV).all() and (k[258:] == INV).all()
    np.testing.assert_array_equal(k[128:258], np.arange(130))
    np.testing.assert_array_equal(v[0].numpy()[:3], [5, 100, 8000])
    assert (v[1].numpy()[258:] == 0).all()


def test_pack_channels_needs_whole_blocks():
    with pytest.raises(ValueError, match="multiple of 8192"):
        pack_channels(torch.zeros(8192 + 256, dtype=torch.int32),
                      tuple(torch.zeros(8192 + 256) for _ in range(4)))


@pytest.mark.parametrize("kernel", ["fused_pass", "segment_combine", "pack_exact",
                                    "pack_channels"])
def test_wrappers_refuse_devices_without_kernel(kernel):
    # the plain version is taken only for CPU tensors; any other device
    # launches the CUDA kernel or raises, never falls back
    from obj2voxel_tpu_torch.ops.combine_pallas import segment_combine
    from obj2voxel_tpu_torch.ops.pass_fused import fused_pass

    keys = torch.zeros(8, dtype=torch.int32, device="meta")
    vals = tuple(torch.zeros(8, device="meta") for _ in range(4))
    with pytest.raises(ValueError, match="unsupported device meta"):
        if kernel == "fused_pass":
            table = torch.zeros((4, 24), device="meta")
            fused_pass(table, 0, 4, 0, 0, 8, 8, expand=1, budget=8)
        elif kernel == "segment_combine":
            segment_combine(keys, *vals, True)
        elif kernel == "pack_channels":
            pack_channels(torch.zeros(8192, dtype=torch.int32, device="meta"),
                          tuple(torch.zeros(8192, device="meta") for _ in range(4)))
        else:
            pack_exact(keys, vals)


@pytest.mark.parametrize("bad", ["dtype", "channels", "shape"])
def test_pack_exact_rejects_bad_inputs(bad):
    keys = torch.zeros(8, dtype=torch.int32)
    vals = tuple(torch.zeros(8) for _ in range(4))
    if bad == "dtype":
        keys = keys.to(torch.int64)
    elif bad == "channels":
        vals = vals[:3]
    else:
        vals = (torch.zeros(9),) + vals[1:]
    with pytest.raises(ValueError):
        pack_exact(keys, vals)
