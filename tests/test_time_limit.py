"""The rules of the repo's root conftest.py: a test that outruns its
`time_limit` fails naming the test and the limit, a test stuck where the alarm
cannot reach it still ends, and every `slow` case it lists is collected."""

import importlib.util
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _load_root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pytest_on(tmp_path, sources, *args):
    """Run pytest on a checkout made of the root conftest.py and `sources`
    ({name: source} of files under tests/)."""
    shutil.copy(ROOT / "conftest.py", tmp_path / "conftest.py")
    (tmp_path / "pytest.ini").write_text(
        "[pytest]\nmarkers =\n    slow\n    time_limit(seconds)\n")
    (tmp_path / "tests").mkdir()
    for name, source in sources.items():
        (tmp_path / "tests" / name).write_text(textwrap.dedent(source))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-q", *args, "tests"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    return proc, proc.stdout + proc.stderr, time.monotonic() - start


def test_a_test_past_its_limit_fails_naming_the_limit(tmp_path):
    proc, out, seconds = _pytest_on(tmp_path, {"test_tmp.py": """
        import time

        import pytest


        @pytest.mark.time_limit(1)
        def test_sleeps_past_its_limit():
            time.sleep(60)


        @pytest.mark.time_limit(30)
        def test_finishes_inside_its_limit():
            time.sleep(0.2)
    """})
    assert proc.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert ("tests/test_tmp.py::test_sleeps_past_its_limit outran its time "
            "limit of 1 s") in out, out
    # the sleep of 60 s was cut, not waited out
    assert seconds < 50


def test_a_test_the_alarm_cannot_reach_still_ends(tmp_path):
    proc, out, seconds = _pytest_on(tmp_path, {
        # three tests, so that --dist loadfile gives this file first
        "test_done.py": """
            def test_one():
                pass


            def test_two():
                pass


            def test_three():
                pass
        """,
        "test_tmp.py": """
            import signal
            import time

            import pytest


            @pytest.mark.time_limit(1)
            def test_stuck_past_the_alarm():
                # a blocked SIGALRM stands for native code that never
                # returns to the interpreter
                signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
                time.sleep(60)


            def test_after_the_stuck_one():
                pass
        """}, "-p", "xdist", "-n", "1", "--dist", "loadfile")
    # The watchdog fires min(1, 60) s after the limit, writes the stuck
    # test's traceback and ends its worker.  A new worker runs the rest of
    # the file, not the stuck test again, and the run ends although the lost
    # worker had finished another file.
    assert proc.returncode == 1, out
    assert "1 failed, 4 passed" in out, out
    assert ("crashed while running "
            "'tests/test_tmp.py::test_stuck_past_the_alarm'") in out, out
    assert "Timeout (0:00:0" in out, out
    assert "in test_stuck_past_the_alarm" in out, out
    assert seconds < 50


def test_every_slow_case_is_collected():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-m", "slow", "--collect-only",
         "-q", "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=200)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    collected = {line for line in proc.stdout.splitlines() if "::" in line}
    slow_cases = set(_load_root_conftest().SLOW_CASES)
    assert collected == slow_cases
    assert len(slow_cases) <= 65
    assert not any(case.startswith("tests/test_torch_") for case in slow_cases)
