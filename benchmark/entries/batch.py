"""Entry "batch": `engine.voxelize_batch` of every mesh of the run, in
model space, with numpy outputs per mesh: the port normalizes, subdivides
and stacks them along z, streams the stack once and splits its output by
mesh.  The reference redoes the transform, the subdivision, the stack and
the split from the meshes' vertices."""

from __future__ import annotations

import numpy as np
from torch.profiler import record_function

from benchmark.harness.adapter import Adapter, Conversion, sync, unit_keys
from benchmark.reference import prepare as ref_prepare
from benchmark.reference.voxelize import voxelize as ref_voxelize


class Entry(Adapter):
    @property
    def n_units(self):
        return len(self.inputs.meshes)

    def setup(self):
        from obj2voxel_tpu_torch.constants import TRI_UNTEXTURED
        from obj2voxel_tpu_torch.soup import TriangleSoup

        if self.inputs.space != "model":
            raise ValueError("batch: needs meshes in model space")
        self.soups = []
        for verts, rgb in self.inputs.meshes:
            n = verts.shape[0]
            self.soups.append(TriangleSoup(
                verts, np.zeros((n, 3, 2), np.float32), np.full(n, TRI_UNTEXTURED, np.int32),
                rgb, np.full(n, -1, np.int32)))

    def convert(self, keep) -> Conversion:
        from obj2voxel_tpu_torch import engine

        out = engine.voxelize_batch(self.soups, resolution=self.resolution,
                                    device=self.device, strategy=self.strategy)
        with record_function("bench.sync"):
            sync(self.device)
        with record_function("bench.keep"):
            voxels = sum(x.shape[0] for x, _ in out)
            if keep == "all":
                units = dict(enumerate(out))
            else:
                # copies: a mesh's arrays are views that would keep the
                # whole batch's output alive
                units = {i: (out[i][0].copy(), out[i][1].copy()) for i in keep}
        return Conversion({"triangles": self.inputs.triangles, "meshes": len(out),
                           "voxels": voxels}, units)

    def unit_arrays(self, unit):
        xyz, argb = unit
        return unit_keys(xyz, self.resolution), np.asarray(argb, np.uint32)

    def free(self):
        self.soups = None

    def reference(self, dtype, device):
        r = self.resolution
        verts_all, rgb_all = [], []
        for i, (verts, rgb) in enumerate(self.inputs.meshes):
            v, index = ref_prepare.subdivide(ref_prepare.to_grid(verts, r))
            v = v.copy()
            v[:, :, 2] += np.float32(i * r)  # the stack along z, in float32
            verts_all.append(v)
            rgb_all.append(rgb[index])
        keys, argb, tied = ref_voxelize(
            np.concatenate(verts_all), np.concatenate(rgb_all), stride=r,
            z_extent=len(self.inputs.meshes) * r, blend=self.blend, device=device,
            dtype=dtype)
        cuts = np.searchsorted(keys // (r ** 3), np.arange(1, len(self.inputs.meshes)))
        return {i: (k - i * r ** 3, a, t) for i, (k, a, t) in enumerate(zip(
            np.split(keys, cuts), np.split(argb, cuts), np.split(tied, cuts)))}
