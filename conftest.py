"""Rules for the tests under tests/: each test's time limit, and which of the
JAX package's own cases are `slow`.

Every test under tests/ gets a time limit on its setup plus its call (a module
fixture's setup counts toward the first test that uses it): 240 s, 3600 s for
a `slow` case, or what @pytest.mark.time_limit(seconds) says.  Two mechanisms
enforce it:

- an ITIMER_REAL alarm whose handler fails the test with a message that names
  it and its limit.  Python runs the handler only between bytecodes, so it
  cuts Python-level waits but not a test stuck in native code (a compile, a
  torch op, a deadlocked thread pool);
- a faulthandler watchdog thread, which fires `min(limit, 60)` s after the
  limit even then: it writes every thread's traceback (the test's frame among
  them) to stderr and ends the process with exit code 1.  Under xdist the
  controller reports the test that was running on the lost worker as failed,
  and the rest of its file goes on on a new worker.

`slow` marks the JAX package's cases that take minutes: interpret-mode
Pallas kernels and jitted XLA CPU programs checked against the same package.
The JAX package is frozen and never runs on the card, so these
self-comparisons cannot change between changes to the port.  Tier 1 runs
`-m 'not slow'`; `python -m pytest tests/ -m slow` runs them.  No port test
(tests/test_torch_*.py) is slow.
"""

import faulthandler
import os
import signal
import sys
import threading
import time
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent / "tests"

#: The limit of a test that is neither `slow` nor marked `time_limit`.
DEFAULT_TIME_LIMIT = 240
#: The limit of a `slow` case.
SLOW_TIME_LIMIT = 3600

#: The JAX package's cases that are `slow`, with the seconds each took alone
#: under tier 1's flags.  "then": once the cases before it in its file were
#: marked, so that it paid the compile they had shared; "full": under tier 1's
#: whole command.
SLOW_CASES = (
    "tests/test_api_errors.py::test_error_on_double_voxelization",  # 112.9
    "tests/test_api_surface.py::test_mesh_boundaries_skip_bounds_computation",  # 154.7
    "tests/test_api_surface.py::test_memory_output_qef",  # 135.9
    "tests/test_batch.py::test_batch_of_cubes",  # 154.4
    "tests/test_batch.py::test_batch_with_empty_mesh",  # 127.6
    "tests/test_cli.py::test_unknown_input_extension_assumes_obj",  # 167.7
    "tests/test_cli.py::test_end_to_end_vl32",  # 228.6
    # whichever single-triangle case of test_clip.py runs first pays the
    # compile of its `clip` fixture (92-110 s); the others then take 0.02 s
    "tests/test_clip.py::test_triangle_fully_inside",  # 91.9
    "tests/test_clip.py::test_triangle_outside",  # then 95.4
    "tests/test_clip.py::test_triangle_clipped_to_half",
    "tests/test_clip.py::test_plane_on_voxel_boundary_belongs_to_hi_voxel",
    "tests/test_clip.py::test_plane_just_below_boundary_epsilon_snaps_lo",
    "tests/test_clip.py::test_uv_centroid_weighting",  # first: 110.4
    "tests/test_clip.py::test_diagonal_triangle_voxel_column",
    "tests/test_clip.py::test_batch_consistency",  # 83.9
    "tests/test_clip.py::test_area_conservation_across_voxels",  # 83.4
    "tests/test_clip_pallas.py::test_pallas_matches_jnp_oracle",  # 101.5
    "tests/test_clip_pallas.py::test_pallas_boundary_semantics",  # 87.1
    "tests/test_debug.py::test_engine_runs_clean_under_debug",  # 102.4
    "tests/test_io.py::test_obj_with_texture_end_to_end",  # 101.1
    "tests/test_merge_pallas.py::test_engine_merge_runs_matches_default[max]",  # 650.9
    "tests/test_merge_pallas.py::test_engine_merge_runs_matches_default[blend]",  # 160.9
    "tests/test_parallel.py::test_sharded_matches_expected_count",  # 197.3
    "tests/test_parallel.py::test_sharded_matches_single_device",  # 90.9
    "tests/test_parallel.py::test_sharded_odd_device_count",  # 251.5
    "tests/test_parallel.py::test_sharded_large_mesh_matches_single_device",  # 839.9
    "tests/test_parallel.py::test_instance_parallel_matches_single_chip",  # 92.3
    "tests/test_parallel.py::test_instance_parallel_with_permutation",  # then 296.3
    "tests/test_parallel.py::test_instance_parallel_with_bounds",  # then 79.3
    "tests/test_parallel.py::test_instance_parallel_blend_supersampled",  # 301.9
    # each [False-*] case pays the interpret-mode compile that its [True-*]
    # sibling (2.5-3.2 s after it) pays when it runs alone
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[False-1]",  # 162.7
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[False-2]",  # 272.3
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[False-8]",  # 366.1
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[False-128]",  # 216.0
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[False-512]",  # 167.2
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[False-8192]",  # 146.7
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[False-16384]",  # 168.7
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[True-1]",
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[True-2]",
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[True-8]",  # alone 225.9
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[True-128]",
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[True-512]",
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[True-8192]",
    "tests/test_pass_fused.py::test_fused_matches_xla_pipeline[True-16384]",
    "tests/test_pass_fused.py::test_fused_ref_weights_mode",  # 198.1
    "tests/test_pass_fused.py::test_batched_pass_matches_single[8]",  # 219.4
    "tests/test_pass_fused.py::test_batched_pass_matches_single[512]",  # 191.3
    "tests/test_pipeline.py::test_unit_cube_expected_voxel_count",  # 87.5
    "tests/test_pipeline.py::test_unit_cube_expected_voxel_count_r64",  # 102.6
    "tests/test_pipeline.py::test_unit_cube_multiple_chunks",  # 582.1
    "tests/test_pipeline.py::test_three_planes_expected_voxel_count",  # then 104.1
    "tests/test_pipeline.py::test_three_planes_multiple_chunks",  # 237.0
    "tests/test_pipeline.py::test_blend_strategy_same_occupancy",  # then 128.1
    "tests/test_pipeline.py::test_supersampling_produces_voxels",  # then, full 234.6
    "tests/test_pipeline.py::test_permutation_swap",  # 99.2
    "tests/test_pipeline.py::test_multipass_host_merge",  # 89.1
    "tests/test_pipeline.py::test_batched_dispatch_equivalence",  # 546.3
    "tests/test_plan_device.py::test_group_engine_output_matches_ungrouped",  # full 397.7
    "tests/test_ply_reader.py::test_ply_reader_end_to_end_voxelization",  # 109.9
    "tests/test_supersampling.py::test_supersampled_cube_positions_exact",  # 96.5
    "tests/test_supersampling.py::test_supersampled_flat_color_survives",  # then, full 267.1
    "tests/test_textures.py::test_materialless_is_white",  # 91.3
    "tests/test_textures.py::test_untextured_flat_color",  # then, full 271.1
    "tests/test_textures.py::test_textured_sampling_with_v_flip",  # 146.8
    "tests/test_textures.py::test_blend_produces_weighted_mean",  # full 108.8
)

_SLOW = frozenset(SLOW_CASES)
_DEADLINE = pytest.StashKey[float]()
_STDERR = pytest.StashKey[int]()


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    # before the mark plugin deselects by -m
    for item in items:
        if item.nodeid in _SLOW:
            item.add_marker(pytest.mark.slow)


def pytest_configure(config):
    # The watchdog writes to the terminal's stderr, not to a test's capture.
    config.stash[_STDERR] = os.dup(sys.stderr.fileno())


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])


def _time_limit(item):
    marker = item.get_closest_marker("time_limit")
    if marker:
        return float(marker.args[0])
    if item.get_closest_marker("slow"):
        return float(SLOW_TIME_LIMIT)
    return float(DEFAULT_TIME_LIMIT)


def _limited(item):
    """Run one phase of `item` under what is left of its limit.  SIGALRM
    reaches only the main thread, where pytest (and each xdist worker) runs
    tests; elsewhere no limit is armed."""
    if (not item.path.is_relative_to(TESTS)
            or threading.current_thread() is not threading.main_thread()):
        yield
        return
    limit = _time_limit(item)

    def on_alarm(signum, frame):
        pytest.fail(f"{item.nodeid} outran its time limit of {limit:g} s "
                    "(setup and call; @pytest.mark.time_limit sets another)",
                    pytrace=False)

    left = max(item.stash[_DEADLINE] - time.monotonic(), 1e-3)
    signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, left)
    faulthandler.dump_traceback_later(
        left + min(limit, 60), exit=True,
        file=item.config.stash[_STDERR])
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(optionalhook=True)
def pytest_handlecrashitem(crashitem, report, sched):
    # A worker was lost.  xdist's --dist loadfile puts every file it had been
    # given back in its queue, done or not, the test that was running
    # included.  Run that test only once, and drop the files with nothing
    # left to run: a new worker given one would run nothing, and the run
    # would wait on it for ever.
    workqueue = getattr(sched, "workqueue", {})
    for scope, work_unit in list(workqueue.items()):
        if crashitem in work_unit:
            work_unit[crashitem] = True
        if all(work_unit.values()):
            del workqueue[scope]


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    item.stash[_DEADLINE] = time.monotonic() + _time_limit(item)
    yield from _limited(item)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield from _limited(item)
