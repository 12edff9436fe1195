"""The port's configs, its independence from JAX, and its device default."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_pose.utils import config as jc
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

REPO = Path(__file__).resolve().parents[1]


def _plain(v):
    """Config values with dataclass instances (the stage schedules) as
    dicts, so the two packages' classes compare by content."""
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


@pytest.mark.parametrize("name", ["CPMConfig", "StageConfig", "FitConfig",
                                  "FrontEndConfig"])
def test_config_fields_and_defaults_match_jax(name):
    """Same fields, same defaults — apart from decode_impl, whose values
    name the port's implementations ("cuda"/"torch" for "pallas"/"xla")
    and whose default "auto" is the same."""
    j = {f.name: _plain(f.default)
         for f in dataclasses.fields(getattr(jc, name))}
    t = {f.name: _plain(f.default)
         for f in dataclasses.fields(getattr(tc, name))}
    assert list(t) == list(j)
    assert t == j


def test_stage_schedules_match_jax():
    assert _plain(tc.DEFAULT_STAGES) == _plain(jc.DEFAULT_STAGES)
    assert _plain(tc.THOROUGH_STAGES) == _plain(jc.THOROUGH_STAGES)
    assert tc.CPMConfig().heatmap_size == jc.CPMConfig().heatmap_size == 46
    assert tc.CPMConfig().out_channels == 15


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, imports with jax, the
    JAX package and tensorflow made unimportable (the TF1 converter
    imports tensorflow inside the function)."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "tpu_pose_torch").rglob("*.py"))
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'optax', 'tpu_pose',\n"
            "          'tensorflow'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda(monkeypatch):
    """Without CUDA and without device=, the entry points raise rather
    than run on the CPU quietly."""
    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.fitting import priors
    from tpu_pose_torch.models import cpm, smpl_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = tc.CPMConfig(input_size=64, features=8, stage1_head_width=8,
                         refine_width=8, num_stages=2)
    for call in (lambda: PoseEstimator.create_synthetic(0, small),
                 lambda: smpl_data.synthetic_smpl(0, num_verts=50),
                 lambda: priors.synthetic_gmm_prior(0),
                 lambda: cpm.init_cpm_params(0, small)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
