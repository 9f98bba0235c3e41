"""K3's and K5's plain versions against the JAX package's pack oracles,
exactly; the wrappers' checks and launch layouts (K2, K3, combine_pack and
K5) without a card."""

import numpy as np
import pytest
import torch

from obj2voxel_tpu.ops.pack_pallas import pack_channels_ref as jax_pack_channels_ref
from obj2voxel_tpu.ops.pack_pallas import pack_exact_ref as jax_pack_exact_ref
from obj2voxel_tpu_torch.ops import _cuda
from obj2voxel_tpu_torch.ops.combine_pallas import combine_pack, segment_combine
from obj2voxel_tpu_torch.ops.pack_pallas import (
    PACK_BLOCK, pack_channels, pack_channels_ref, pack_exact, pack_exact_ref,
)
from obj2voxel_tpu_torch.ops.reduce_by_key import RBK_TILE

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
                                    "pack_channels", "combine_pack"])
def test_wrappers_refuse_devices_without_kernel(kernel):
    # the plain version is taken only for CPU tensors; any other device
    # launches the CUDA kernel or raises, never falls back
    from obj2voxel_tpu_torch.ops.pass_fused import fused_pass

    keys = torch.zeros(8, dtype=torch.int32, device="meta")
    vals = tuple(torch.zeros(8, device="meta") for _ in range(4))
    with pytest.raises(ValueError, match="unsupported device meta"):
        if kernel == "fused_pass":
            table = torch.zeros((4, 24), device="meta")
            fused_pass(table, 0, 4, 0, 0, 8, 8, expand=1, budget=8)
        elif kernel == "segment_combine":
            segment_combine(keys, *vals, True)
        elif kernel == "combine_pack":
            combine_pack(keys, vals, True)
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


@pytest.mark.parametrize("blocks", [1, 3, 512, 2048])
def test_pack_channels_wrapper_layout(monkeypatch, blocks):
    # one call, one launch count, one buffer: the five output rows, the
    # count and a pad, then the look-back's status word of each 8192-slot
    # block and its ticket (8-byte aligned; the launcher zeroes them).  A
    # meta tensor's pointer is 0, so the pointers passed are byte offsets.
    calls = []

    class Lib:
        def o2v_pack_channels(self, *args):
            calls.append(args)
            return 0

    made = []
    empty = torch.empty

    def tracked_empty(*size, **kw):
        made.append(empty(*size, **kw))
        return made[-1]

    monkeypatch.setattr(_cuda, "lib", Lib)
    monkeypatch.setattr(_cuda, "require_cuda", lambda name, *t: t[0].device)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    n = blocks * PACK_BLOCK
    keys = torch.zeros(n, dtype=torch.int32, device="meta")
    vals = tuple(torch.zeros(n, device="meta") for _ in range(4))
    monkeypatch.setattr(torch, "empty", tracked_empty)
    _cuda.reset_launches()
    k, v, count = pack_channels(keys, vals)
    assert _cuda.LAUNCHES["pack_channels"] == len(calls) == 1
    (buf,) = made
    assert buf.dtype == torch.int32 and buf.numel() == 5 * n + 2 * blocks + 4
    outs, count_at, status_at, rows = calls[0][5:10], *calls[0][10:13]
    assert list(outs) == [4 * n * i for i in range(5)] and rows == n
    assert count_at == 20 * n and status_at % 8 == 0
    assert count_at + 4 <= status_at and status_at + 8 * (blocks + 1) <= 4 * buf.numel()
    # the returned tensors are the views the pointers name
    assert count.dtype == torch.int32 and count.shape == (1,)
    assert 4 * count.storage_offset() == count_at
    assert k.dtype == torch.int32 and k.shape == keys.shape and k.storage_offset() == 0
    for i, x in enumerate(v, 1):
        assert x.dtype == torch.float32 and x.shape == keys.shape
        assert 4 * x.storage_offset() == outs[i]


@pytest.mark.parametrize("bad", ["dtype", "channels", "shape", "two_d"])
def test_pack_channels_rejects_bad_inputs(bad):
    keys = torch.zeros(PACK_BLOCK, dtype=torch.int32)
    vals = tuple(torch.zeros(PACK_BLOCK) for _ in range(4))
    if bad == "dtype":
        keys = keys.to(torch.int64)
    elif bad == "channels":
        vals = vals[:3]
    elif bad == "shape":
        vals = (torch.zeros(2 * PACK_BLOCK),) + vals[1:]
    else:
        keys = keys.reshape(2, -1)
    with pytest.raises(ValueError):
        pack_channels(keys, vals)


@pytest.mark.parametrize("bad", ["dtype", "channels", "shape", "two_d"])
def test_combine_pack_rejects_bad_inputs(bad):
    keys = torch.zeros(8, dtype=torch.int32)
    vals = tuple(torch.zeros(8) for _ in range(4))
    if bad == "dtype":
        vals = (vals[0].to(torch.float64),) + vals[1:]
    elif bad == "channels":
        vals = vals[:3]
    elif bad == "shape":
        vals = (torch.zeros(9),) + vals[1:]
    else:
        keys = keys.reshape(2, -1)
    with pytest.raises(ValueError):
        combine_pack(keys, vals, True)


def _segment_combine(keys, vals, is_blend):
    return segment_combine(keys, *vals, is_blend)


# name -> (wrapper, combine, compact)
RBK_INSTANCES = {
    "combine_pack": (combine_pack, True, True),
    "segment_combine": (_segment_combine, True, False),
    "pack_exact": (lambda k, v, _: pack_exact(k, v), False, True),
}


@pytest.mark.parametrize("rows", [1, RBK_TILE, 3 * RBK_TILE + 5])
@pytest.mark.parametrize("name", list(RBK_INSTANCES))
def test_reduce_by_key_wrapper_layout(monkeypatch, name, rows):
    # one call, one launch count, two buffers: the five output rows, then
    # the count and (16-byte aligned) the scratch of 44 B a 4096-row tile
    # plus 4 (the launcher zeroes its flags), so a kept count does not keep
    # the rows alive.  A meta tensor's pointer is 0, so each pointer is the
    # byte offset in its buffer.
    wrapper, combine, compact = RBK_INSTANCES[name]
    calls = []

    class Lib:
        def o2v_reduce_by_key(self, *args):
            calls.append(args)
            return 0

    made = []
    empty = torch.empty

    def tracked_empty(*size, **kw):
        made.append(empty(*size, **kw))
        return made[-1]

    monkeypatch.setattr(_cuda, "lib", Lib)
    monkeypatch.setattr(_cuda, "require_cuda", lambda name, *t: t[0].device)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    n = rows
    keys = torch.zeros(n, dtype=torch.int32, device="meta")
    vals = tuple(torch.zeros(n, device="meta") for _ in range(4))
    monkeypatch.setattr(torch, "empty", tracked_empty)
    _cuda.reset_launches()
    out = wrapper(keys, vals, False)
    assert _cuda.LAUNCHES[name] == len(calls) == 1
    assert sum(_cuda.LAUNCHES.values()) == 1
    buf, aux = made
    args = calls[0]
    outs, count_at, scratch_at = args[5:10], args[10], args[11]
    assert args[12:16] == (n, int(combine), int(compact), 0)
    assert buf.dtype == torch.int32 and buf.numel() == 5 * n
    assert list(outs) == [4 * n * i for i in range(5)]
    tiles = -(-n // RBK_TILE)
    assert aux.dtype == torch.int32 and count_at == 0 and scratch_at == 16
    assert 16 + 44 * tiles + 4 <= 4 * aux.numel() < 16 + 44 * tiles + 8
    # the returned tensors are the views the pointers name
    k, v = out[0], out[1:] if name == "segment_combine" else out[1]
    assert k.dtype == torch.int32 and k.shape == keys.shape and k.storage_offset() == 0
    for i, x in enumerate(v, 1):
        assert x.dtype == torch.float32 and x.shape == keys.shape
        assert 4 * x.storage_offset() == outs[i]
    if compact:
        assert out[2].shape == (1,) and out[2].storage_offset() == 0
        assert out[2].untyped_storage().nbytes() == 4 * aux.numel()
