"""The port's native host codec builds safely when several processes load it
at once, as the test workers and concurrent CLI runs do.

Each round points the module's build directory at an empty directory and
starts ``PROCESSES`` interpreters together; each loads the module from its
file (numpy only, no torch), waits for a common start time, and reports
``is_available()`` and ``build_error()``.  Every one must have loaded the
library: none may open a file that another process is still writing.

The library is built with ``-march=native``, so a stamp beside it names the
machine and compiler that built it.  A library whose stamp is missing or
names another machine (a working copy carried to another host) is rebuilt,
and one whose stamp matches is loaded as it is.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

import datacomp_tpu_torch.native as pnative

PROCESSES = 6
ROUNDS = 3

_LOADER = r"""
import importlib.util, json, sys, time
path, build_dir, start = sys.argv[1], sys.argv[2], float(sys.argv[3])
spec = importlib.util.spec_from_file_location("native_under_test", path)
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
native._BUILD_DIR = build_dir
native._LIB_PATH = build_dir + "/libdcz_native.so"
while time.time() < start:
    time.sleep(0.001)
print(json.dumps({"available": native.is_available(), "error": native.build_error()}))
"""


def _round(build_dir: str) -> list:
    start = time.time() + 1.0  # every process has imported numpy by then
    procs = [subprocess.Popen([sys.executable, "-c", _LOADER, pnative.__file__, build_dir,
                               repr(start)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(PROCESSES)]
    reports = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        reports.append(json.loads(out.strip().splitlines()[-1]))
    return reports


def test_concurrent_first_loads_all_get_the_library(tmp_path):
    for i in range(ROUNDS):
        build_dir = str(tmp_path / f"round{i}")
        reports = _round(build_dir)
        assert reports == [{"available": True, "error": None}] * PROCESSES, reports
        # the library and its stamp alone are left, no compiler output of any process
        assert sorted(os.listdir(build_dir)) == [
            "libdcz_native.so", "libdcz_native.so.stamp", "native.lock"]


def _fresh_native(build_dir: str):
    """A new instance of the module, as a new process has, building in
    ``build_dir``."""
    spec = importlib.util.spec_from_file_location("native_under_test", pnative.__file__)
    native = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(native)
    native._BUILD_DIR = build_dir
    native._LIB_PATH = os.path.join(build_dir, "libdcz_native.so")
    return native


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A library built on this machine, with its stamp."""
    build_dir = str(tmp_path_factory.mktemp("built"))
    native = _fresh_native(build_dir)
    assert native.is_available(), native.build_error()
    with open(native._stamp_path()) as f:
        stamp = f.read()
    assert stamp.startswith(f"machine {native._machine_key()}\nflags -O3 -march=native "), stamp
    return native._LIB_PATH, stamp


@pytest.mark.parametrize("stamp", ["foreign", "missing", "no machine line", "matching"])
def test_library_is_rebuilt_unless_stamped_by_this_machine(tmp_path, built, stamp):
    lib, good = built
    native = _fresh_native(str(tmp_path))
    shutil.copy(lib, native._LIB_PATH)  # newer than the source: only the stamp decides
    planted = {"foreign": "machine " + "0" * 64 + "\nflags -O3 -march=native\n",
               "no machine line": good.split("\n", 1)[1], "matching": good}.get(stamp)
    if planted is not None:
        with open(native._stamp_path(), "w") as f:
            f.write(planted)
    before = os.stat(native._LIB_PATH)
    assert native._stale() == (stamp != "matching")
    assert native.is_available(), native.build_error()
    after = os.stat(native._LIB_PATH)
    rebuilt = (after.st_ino, after.st_mtime_ns) != (before.st_ino, before.st_mtime_ns)
    assert rebuilt == (stamp != "matching")
    with open(native._stamp_path()) as f:
        assert f.read() == good
    assert not native._stale()
    assert sorted(os.listdir(tmp_path)) == (
        ["libdcz_native.so", "libdcz_native.so.stamp"] + (["native.lock"] if rebuilt else []))


def test_stamp_says_when_the_build_fell_back_to_plain_flags(tmp_path, monkeypatch):
    native = _fresh_native(str(tmp_path))
    real = subprocess.run

    def no_march_native(cmd, *args, **kwargs):
        if "-march=native" in cmd and "-o" in cmd:
            raise subprocess.CalledProcessError(1, cmd)
        return real(cmd, *args, **kwargs)

    monkeypatch.setattr(native.subprocess, "run", no_march_native)
    assert native.is_available(), native.build_error()
    with open(native._stamp_path()) as f:
        machine, flags = f.read().splitlines()
    assert machine == f"machine {native._machine_key()}"
    assert flags == "flags -O3 -funroll-loops -std=c++17 -shared -fPIC (plain: -march=native refused)"
    assert not native._stale()  # the machine, not the flags, decides
