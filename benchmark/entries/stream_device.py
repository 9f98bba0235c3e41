"""Entry "stream_device": `engine.stream_slabs(device_outputs=True)` over
the port's table of one mesh already in the grid, built once in set-up by
the port's `host_table` and uploaded: the outputs stay on the device, as
a GPU-side consumer keeps them, and every output voxel is folded into a
digest on the device.  The reference voxelizes the mesh's vertices."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness.adapter import Adapter, Conversion, fold, sync, unit_keys
from benchmark.reference.voxelize import voxelize as ref_voxelize


class Entry(Adapter):
    n_units = 1

    def setup(self):
        from obj2voxel_tpu_torch.constants import TRI_UNTEXTURED
        from obj2voxel_tpu_torch.engine import host_table

        if self.inputs.space != "grid" or len(self.inputs.meshes) != 1:
            raise ValueError("stream_device: needs one mesh in the grid")
        verts, rgb = self.inputs.meshes[0]
        n = verts.shape[0]
        with record_function("bench.table"):
            table, self.aabb = host_table(
                verts, np.zeros((n, 3, 2), np.float32), np.full(n, TRI_UNTEXTURED, np.int32),
                rgb, np.full(n, -1, np.int32), stride=self.resolution,
                z_extent=self.resolution)
            self.table = torch.from_numpy(table).to(self.device)
        del table
        sync(self.device)

    def convert(self, keep) -> Conversion:
        from obj2voxel_tpu_torch import engine

        r = self.resolution
        digest = torch.zeros((), dtype=torch.int64, device=self.device)
        kept = [] if keep == "all" or 0 in keep else None
        voxels = 0
        for xyz, argb, count in engine.stream_slabs(
                self.table, None, aabb_host=self.aabb, stride=r, z_extent=r,
                is_blend=self.blend, device_outputs=True):
            with record_function("bench.fold"):
                voxels += count
                digest += fold(xyz[:count], argb[:count], r)
                if kept is not None:
                    kept.append((xyz[:count].clone(), argb[:count].clone()))
        with record_function("bench.sync"):
            sync(self.device)
        units = {}
        if kept is not None:
            units[0] = (torch.cat([x for x, _ in kept] or [torch.zeros((0, 3), dtype=torch.int32)]),
                        torch.cat([a for _, a in kept] or [torch.zeros(0, dtype=torch.int32)]))
        return Conversion({"triangles": self.inputs.triangles, "meshes": 1,
                           "voxels": voxels}, units, digest)

    def unit_arrays(self, unit):
        xyz, argb = unit
        return (unit_keys(xyz.cpu().numpy(), self.resolution),
                argb.cpu().view(torch.int32).numpy().view(np.uint32))

    def free(self):
        self.table = None

    def reference(self, dtype, device):
        verts, rgb = self.inputs.meshes[0]
        return {0: ref_voxelize(verts, rgb, stride=self.resolution,
                                z_extent=self.resolution, blend=self.blend,
                                device=device, dtype=dtype)}
