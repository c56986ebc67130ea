"""chip_smoke.py refuses to run without a CUDA device and prints no result."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout
