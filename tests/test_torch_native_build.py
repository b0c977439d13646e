"""The port's native host codec builds safely when several processes load it
at once, as the test workers and concurrent CLI runs do.

Each round points the module's build directory at an empty directory and
starts ``PROCESSES`` interpreters together; each loads the module from its
file (numpy only, no torch), waits for a common start time, and reports
``is_available()`` and ``build_error()``.  Every one must have loaded the
library: none may open a file that another process is still writing.
"""

import json
import os
import subprocess
import sys
import time

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
        # the library alone is left, no compiler output of any process
        assert sorted(os.listdir(build_dir)) == ["libdcz_native.so", "native.lock"]
