"""What the CPU can check of chip_smoke.py: it refuses to run without a
GPU or outside the repository, printing no result, and its profile
accounting counts each kernel's device time once."""

import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU; this machine has one")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_refuses_without_gpu_or_repo(no_gpu, where, tmp_path):
    """Without CUDA (and, alone in a directory, without the package) the
    script exits non-zero and prints no result line."""
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    proc = _run(cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    if where == "repo":
        assert proc.returncode == 2 and "needs an NVIDIA GPU" in proc.stderr


def test_kernel_rows_count_device_time_once():
    """An operator's profiler row carries the device time of the kernel
    it launched, which has a row of its own: only the kernel row counts."""
    events = [
        SimpleNamespace(key="aten::copy_", count=3,
                        self_device_time_total=55.0,
                        device_type=DeviceType.CPU),
        SimpleNamespace(key="elementwise_kernel", count=3,
                        self_device_time_total=55.0,
                        device_type=DeviceType.CUDA),
        SimpleNamespace(key="gemm", count=1, self_device_time_total=80.0,
                        device_type=DeviceType.CUDA),
        SimpleNamespace(key="aten::empty", count=9, self_device_time_total=0.0,
                        device_type=DeviceType.CPU),
    ]
    rows = chip_smoke.kernel_rows(events)
    assert rows == [("gemm", 1, 80.0), ("elementwise_kernel", 3, 55.0)]
    assert sum(r[2] for r in rows) == 135.0
