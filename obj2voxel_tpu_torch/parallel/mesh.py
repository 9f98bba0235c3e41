"""Multi-device voxelization: each device streams its own z window.

The port of obj2voxel_tpu/parallel/mesh.py, in PyTorch's idiom rather than
the SPMD one.  The grid is cut into equal-height, even-aligned z windows
(`_device_windows`, the JAX package's arithmetic), one a device.  Each
device gets a copy of the (N, 24) triangle table and of the texture pool and
streams its window through the single-device slab loop
(`engine.stream_slabs(z_window=...)`): the planner plans only the window's
rows, in slabs that tile it, so no slab straddles a window edge and no voxel
is emitted by two windows.  There are no collectives: windows are disjoint
in z and every voxel is combined within one slab.

The windows run concurrently, one host thread a distinct device (kernels
and torch ops release the interpreter lock, so one device's count read-back
does not stall another); a device listed more than once runs its windows in
turn, in z order.  Batches are yielded in completion order, as in the JAX
package (the reference's sink order is chunk-completion order,
obj2voxel.cpp:298-303).

Left out: the JAX package's lockstep shape classes, empty rounds and
lockstep sub-slabs (obj2voxel_tpu/parallel/mesh.py:339-383), which exist so
that `shard_map` runs one program on every chip; here each window's slab
loop caps its own key heights.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading

import numpy as np
import torch

from ..constants import BLEND_STRATEGY, MAX_STRATEGY, PAIR_TILE
from ..engine import (
    MAX_PASS_BUDGET, PLAN_GROUP, host_table, prepare_soup, stream_slabs,
)
from ..ops.color import upload_pool
from ..soup import TexturePool, TriangleSoup

__all__ = ["parallel_devices", "stream_sharded", "voxelize_sharded"]


def _device_windows(z_extent: int, n_devices: int, align: int = 2):
    """Equal-height (last may be short), even-aligned per-device z ranges."""
    h = -(-z_extent // n_devices)
    if h % align:
        h += align - h % align
    return [(min(d * h, z_extent), min((d + 1) * h, z_extent)) for d in range(n_devices)], h


def parallel_devices(device="cuda"):
    """The devices to shard over: every visible CUDA device when `device`
    is a CUDA device, else `device` alone (`stream_sharded`'s default, and
    Instance.voxelize's under set_parallel(True))."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def voxelize_sharded(soup: TriangleSoup, pool: TexturePool | None = None, **kwargs):
    """Voxelize across devices; returns (xyz (K, 3) int32, argb (K,) uint32).

    Collector over `stream_sharded`, whose keywords it takes."""
    out = list(stream_sharded(soup, pool, **kwargs))
    if not out:
        return np.zeros((0, 3), np.int32), np.zeros((0,), np.uint32)
    return np.concatenate([x for x, _ in out]), np.concatenate([a for _, a in out])


def stream_sharded(
    soup: TriangleSoup,
    pool: TexturePool | None = None,
    *,
    resolution: int,
    strategy: int = MAX_STRATEGY,
    supersampling: int = 1,
    unit_transform=None,
    bounds=None,
    n_devices: int | None = None,
    devices=None,
    pair_tile: int = PAIR_TILE,
    max_pass_budget: int = MAX_PASS_BUDGET,
    tile_size: int | None = None,
):
    """Voxelize `soup` in `n_devices` z windows over `devices` (default:
    every visible CUDA device, one window each); window d runs on
    devices[d % len(devices)].  Yields (xyz (K, 3) int32, argb (K,) uint32)
    numpy batches, one a slab, in completion order.  The voxels are
    `engine.voxelize_soup`'s with the same options.  `tile_size` is the
    JAX package's deprecated alias for the pass budget.  O2V_GROUP, read
    once here, sets every window's planning unit (obj2voxel_tpu/parallel/
    mesh.py:309); the other knobs are read by each window's `stream_slabs`."""
    devices = [torch.device(d) for d in (parallel_devices() if devices is None
                                         else devices)]
    n_devices = len(devices) if n_devices is None else n_devices
    if not devices or n_devices < 1:
        raise ValueError("stream_sharded: no device to run on")
    if tile_size is not None:
        max_pass_budget = min(max_pass_budget, tile_size)
    if len(soup) == 0:
        return

    sample_res = resolution * supersampling
    table, aabb = host_table(
        *prepare_soup(soup, sample_res, unit_transform, bounds),
        stride=sample_res, z_extent=sample_res,
    )
    jobs: dict[torch.device, list] = {}
    for d, (z0, z1) in enumerate(_device_windows(sample_res, n_devices)[0]):
        if z1 > z0:
            jobs.setdefault(devices[d % len(devices)], []).append((z0, z1))
    kw = dict(aabb_host=aabb, stride=sample_res, z_extent=sample_res,
              is_blend=bool(strategy == BLEND_STRATEGY),
              do_down=bool(supersampling > 1), pair_tile=pair_tile,
              max_pass_budget=max_pass_budget,
              group=int(os.environ.get("O2V_GROUP", PLAN_GROUP)))

    def windows_on(device, windows):
        """One device's windows in turn, on its own copy of the table."""
        table_dev = torch.from_numpy(table).to(device)
        pool_dev = upload_pool(pool, device)
        for z_window in windows:
            yield from stream_slabs(table_dev, pool_dev, z_window=z_window, **kw)

    yield from _concurrently(windows_on, jobs)


class _Failure:
    def __init__(self, exc):
        self.exc = exc


_DONE = object()


def _concurrently(gen_fn, jobs):
    """Drain gen_fn(device, windows) for every job, one thread a device;
    yield the items in completion order.  A worker's exception is raised
    here; closing this generator stops the workers after their current
    item and joins them."""
    out = queue.SimpleQueue()
    stop = threading.Event()

    def work(device, windows):
        ctx = (torch.cuda.device(device) if device.type == "cuda"
               else contextlib.nullcontext())
        try:
            with ctx:
                for item in gen_fn(device, windows):
                    if stop.is_set():
                        break
                    out.put(item)
        except Exception as exc:  # the consumer raises it
            out.put(_Failure(exc))
        finally:
            out.put(_DONE)

    threads = [threading.Thread(target=work, args=job, name=f"o2v-{job[0]}")
               for job in jobs.items()]
    for t in threads:
        t.start()
    try:
        running = len(threads)
        while running:
            item = out.get()
            if item is _DONE:
                running -= 1
            elif isinstance(item, _Failure):
                raise item.exc
            else:
                yield item
    finally:
        stop.set()
        for t in threads:
            t.join()
