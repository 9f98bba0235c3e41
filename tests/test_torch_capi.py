"""The port's C shim (libobj2voxel_tpu_torch.so, native/) on the CPU.

Builds the shim and native/test/capi_test.c into a temporary directory with
CMake, then runs the test program with OBJ2VOXEL_DEVICE=cpu: it voxelizes
the unit cube through the callback API and checks the closed form (5768
voxels at r = 32) and the ERR_NO_INPUT error path.  A `jax` package that
fails on import is put first on the embedded interpreter's path, so the run
also shows that the shim reaches the port and nothing of JAX.
"""

import subprocess

from obj2voxel_tpu_torch.capi import build_shim, shim_env


def test_capi_test_passes_on_the_cpu(tmp_path):
    exe = build_shim(tmp_path / "build")
    fake = tmp_path / "nojax" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(
        'raise ImportError("the port\'s C shim imported jax")\n')
    env = shim_env("cpu")
    env["PYTHONPATH"] = f"{fake.parent}:{env['PYTHONPATH']}"
    proc = subprocess.run([str(exe)], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "voxels: 5768 expected: 5768" in proc.stdout
    assert "C API smoke test PASSED" in proc.stdout
