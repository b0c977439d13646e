"""On the card: a short run of each cell's control, at the cell's own file
and chunk sizes, must come out incorrect, and a sound run correct.  Skips
without a CUDA card (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(workload: str, seed: int, control: bool) -> dict:
    cmd = [sys.executable, "-m", "dczbench", "--workload", workload, "--seed", str(seed),
           "--seconds", "4", "--trace", "0"] + (["--control"] if control else [])
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["fast-v2.silesia", "device-v2.silesia"])
def test_control_on_the_card_is_incorrect(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert _run(workload, 2**31 + 301, control=False)["correct"]
    result = _run(workload, 2**31 + 302, control=True)
    assert not result["correct"]
    assert result["checks"]["codebook_faults"]["value"] > 0
