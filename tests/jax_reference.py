"""The frozen JAX package's outputs on the port's test inputs.

The port's tests hold `obj2voxel_tpu_torch` to `obj2voxel_tpu`, which is
frozen: on fixed inputs its outputs cannot change.  So the JAX calls that
cost seconds (op by op under `jax.disable_jit()`, jitted, or Pallas in
interpret mode) run once, in scripts/jax_test_references.py, which writes
tests/fixtures/jax_<group>.npz.  For each case a fixture holds the sha256
of the case's inputs and the outputs its test compares.

A test builds its inputs as before and calls `reference(group, case,
*arrays, **params)`: that checks the inputs' digest against the fixture's
and returns the stored outputs, which the test compares with the port
under the same assertion as before.  A changed input fails the digest;
regenerate the group then:

    JAX_PLATFORMS=cpu python3 scripts/jax_test_references.py <group>
"""

from __future__ import annotations

import functools
import hashlib
import json
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def fixture_path(group: str) -> Path:
    return FIXTURES / f"jax_{group}.npz"


def digest(*arrays, **params) -> str:
    """sha256 of arrays (dtype, shape and bytes, in order) and of JSON
    scalar parameters (Python numbers, strings, booleans, None)."""
    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, (bytes, bytearray)):
            a = np.frombuffer(a, np.uint8)
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    h.update(json.dumps(params, sort_keys=True).encode())
    return h.hexdigest()


@functools.cache
def _load(group: str) -> dict:
    data = {}
    with np.load(fixture_path(group)) as z:
        for k in z.files:
            data[k] = z[k]
            data[k].flags.writeable = False  # shared by every test of the group
    return data


def reference(group: str, case: str, /, *arrays, **params) -> dict:
    """The JAX outputs stored for `case`, after checking that `arrays` and
    `params` are the inputs they were computed from."""
    data = _load(group)
    key = f"{case}__sha256"
    assert key in data, f"{fixture_path(group).name} has no case {case!r}"
    assert str(data[key]) == digest(*arrays, **params), (
        f"{group}/{case}: the inputs differ from those "
        f"{fixture_path(group).name} was written from; rerun "
        f"scripts/jax_test_references.py {group}.  Where the inputs come "
        "from the port's code (build_tri_table), a change there must first "
        "give the JAX package's inputs too: the script checks the tables")
    prefix = f"{case}__"
    return {k[len(prefix):]: v for k, v in data.items()
            if k.startswith(prefix) and k != key}


def voxel_dict(ref: dict, prefix: str = "") -> dict:
    """{(x, y, z): argb} of stored voxels, in the reference's order."""
    xyz = ref[f"{prefix}xyz"].astype(np.int32)
    argb = ref[f"{prefix}argb"]
    return dict(zip(map(tuple, xyz.tolist()), argb.tolist()))


def voxel_arrays(batches, prefix: str = "") -> dict:
    """A generator's (xyz, argb) batches as the arrays `voxel_dict` reads,
    xyz in the narrowest dtype that holds it (the fixtures stay small)."""
    batches = list(batches)
    xyz = (np.concatenate([np.asarray(x) for x, _ in batches]) if batches
           else np.zeros((0, 3), np.int32))
    argb = (np.concatenate([np.asarray(a) for _, a in batches]) if batches
            else np.zeros(0, np.uint32))
    assert len(set(map(tuple, xyz.tolist()))) == xyz.shape[0], "duplicate voxel"
    assert not xyz.size or int(xyz.min()) >= 0
    hi = int(xyz.max()) if xyz.size else 0
    dtype = next(dt for dt in (np.uint8, np.uint16, np.int32) if hi <= np.iinfo(dt).max)
    return {f"{prefix}xyz": xyz.astype(dtype), f"{prefix}argb": argb.astype(np.uint32)}
