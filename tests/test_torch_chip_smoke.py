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


def test_conv_input_hw_matches_the_forward():
    """The conv input sizes the launch counts are computed from are those
    a forward sees, for the full model (368: 184, 92, 46 after the pools)
    and a small one with an odd size (ceil halving)."""
    from tpu_pose_torch.models import cpm as cpm_lib
    from tpu_pose_torch.utils.config import CPMConfig
    hw = chip_smoke.conv_input_hw(CPMConfig())
    assert (hw["conv1_stage2"], hw["conv2_stage1"], hw["conv3_stage2"],
            hw["conv4_stage1"], hw["Mconv5_stage6"]) == (368, 184, 92, 46, 46)
    cfg = CPMConfig(input_size=36, features=8, stage1_head_width=16,
                    refine_width=8, num_stages=2, compute_dtype="float32")
    seen = {}
    with torch.no_grad():
        cpm_lib.cpm_forward(cpm_lib.init_cpm_params(0, cfg, device="cpu"),
                            torch.zeros(1, 36, 36, 3),
                            torch.zeros(1, 36, 36, 1), cfg,
                            on_conv_input=lambda n, h: seen.update(
                                {n: h.shape[-1]}))
    assert chip_smoke.conv_input_hw(cfg) == seen


def test_int8_launches_per_chunk():
    """B2's launches per chunk of 16 at full width: a quantize pass for
    each of the 12 1×1 convs, one fused gather per tile of the 28 others
    (84, from int8_conv's tiling), and 40 abs-max passes with dynamic
    scales; and what the tiling gives at another budget."""
    from tpu_pose_torch.models import cpm as cpm_lib
    from tpu_pose_torch.utils.config import CPMConfig
    q = cpm_lib.QuantizedCPM(CPMConfig())
    assert chip_smoke.int8_launches(q, CPMConfig(), 16, False) == {
        "quantize_act": 12, "quantize_im2col": 84, "quantize_act_absmax": 0}
    assert chip_smoke.int8_launches(q, CPMConfig(), 16, True)[
        "quantize_act_absmax"] == 40
    assert chip_smoke.im2col_tiles((16, 184, 184, 128), 9, 128)[:2] == [
        (0, 1, 0, 184), (1, 2, 0, 184)]
    assert chip_smoke.im2col_tiles((16, 368, 368, 3), 9, 128)[-2:] == [
        (12, 15, 0, 368), (15, 16, 0, 368)]


@pytest.mark.parametrize("batch", [5, 1])
@pytest.mark.parametrize("dynamic", [False, True])
def test_int8_launches_grouped_match_a_counted_run(counted, monkeypatch,
                                                   dynamic, batch):
    """B2 per int8 pass with a symbolic batch (ops/quantize.
    _int8_conv_grouped, the form an exported program runs): for each k×k
    conv the tiles of one group for each group of the batch padded to
    whole groups, computed by int8_launches(grouped=True), equal to the
    functional gather's calls in a counted run at a batch of 5 (not a
    multiple of the group of 2) and of 1, with whole-image and row-run
    tiles; with scan_repeats, one group more per conv."""
    from tpu_pose_torch.models import cpm as cpm_lib
    from tpu_pose_torch.ops import cuda_kernels
    from tpu_pose_torch.ops import quantize as quantize_lib
    monkeypatch.setattr(quantize_lib, "TILE_BYTES", 10 ** 6)
    monkeypatch.setattr(quantize_lib, "GROUP_IMAGES", 2)
    monkeypatch.setattr(quantize_lib, "int8_conv",
                        quantize_lib._int8_conv_grouped)
    tile_op = cuda_kernels.quantize_im2col_tile_cuda

    def tile_counted(*args, **kw):
        counted["quantize_im2col"] += 1
        return tile_op(*args, **kw)

    monkeypatch.setattr(cuda_kernels, "quantize_im2col_tile_cuda",
                        tile_counted)
    cfg, cpm = _small_multi()
    q = cpm_lib.quantize_params(cpm, None if dynamic else {
        name: 0.05 for name, *_ in cpm_lib._layer_defs(cfg)})
    with torch.no_grad():
        cpm_lib.estimate_2d_from_images(q, torch.zeros(batch, 64, 64, 3),
                                        cfg)
    want = chip_smoke.int8_launches(q, cfg, batch, dynamic, grouped=True)
    assert {k: counted[k] for k in want} == want
    static = chip_smoke.int8_launches(q, cfg, batch, dynamic)
    assert want["quantize_im2col"] > static["quantize_im2col"] or batch == 1
    again = chip_smoke.int8_launches(q, cfg, batch, dynamic, grouped=True,
                                     scan_repeats=1)
    n_gathered = sum(1 for layer in q.children() if layer.kernel_size > 1)
    assert again["quantize_im2col"] >= want["quantize_im2col"] + n_gathered


def test_int8_launches_with_refine_scale():
    """With refine_scale a pass runs stage 1 twice (the crop round), so
    the 7 stage-1 convs launch twice and the 33 others once."""
    from tpu_pose_torch.models import cpm as cpm_lib
    from tpu_pose_torch.utils.config import CPMConfig
    q = cpm_lib.QuantizedCPM(CPMConfig())
    once = chip_smoke.int8_launches(q, CPMConfig(), 16, True)
    twice = chip_smoke.int8_launches(q, CPMConfig(), 16, True, stage1_runs=2)
    stage1 = {k: twice[k] - once[k] for k in once}
    assert stage1["quantize_act"] == 2              # conv6, conv7 (1×1)
    assert stage1["quantize_act_absmax"] == 7
    assert stage1["quantize_im2col"] == sum(
        len(chip_smoke.im2col_tiles((16, hw, hw, c), k, n))
        for hw, c, k, n in ((368, 3, 9, 128), (184, 128, 9, 128),
                            (92, 128, 9, 128), (46, 128, 5, 32),
                            (46, 32, 9, 512)))


def test_im2col_bound_counts_rows_written_and_input_read():
    """The gather's byte bound: the tile's rows (m × K_pad) written once
    plus the input rows the tile covers (its rows and k//2 more on each
    side inside the image) read once, over 3.35 TB/s."""
    x = torch.zeros(4, 10, 6, 3, dtype=torch.float32)
    bound, by = chip_smoke.im2col_bound_ms(x, 5, (1, 2, 0, 4))
    read = 1 * 6 * 6 * 3 * 4                   # rows 0..5
    write = 1 * 4 * 6 * 80                      # K 75 -> 80
    assert by == "bytes"
    assert bound == pytest.approx((read + write) / 3.35e12 * 1e3)


# -- the multi-person paths' launch counts, against a counted CPU run --------

KERNEL_WRAPPERS = {"soft_argmax": "soft_argmax_cuda",
                   "quantize_act": "quantize_act_cuda",
                   "quantize_act_absmax": "act_scale_cuda",
                   "quantize_im2col": "quantize_im2col_cuda"}


@pytest.fixture
def counted(monkeypatch):
    """Each kernel wrapper's calls, counted as the card counts its
    launches: every call of a wrapper launches its kernel on a CUDA
    tensor, except the abs-max pass, which a static scale skips and which
    the quantize pass runs first with a dynamic scale. On the CPU the
    wrappers run the plain versions and count nothing themselves."""
    from tpu_pose_torch.ops import cuda_kernels
    counts = dict.fromkeys(KERNEL_WRAPPERS, 0)
    for key, name in KERNEL_WRAPPERS.items():
        def wrapper(*args, _orig=getattr(cuda_kernels, name), _key=key,
                    **kw):
            a_scale = args[1] if len(args) > 1 else kw.get("a_scale")
            if _key != "quantize_act_absmax" or a_scale is None:
                counts[_key] += 1
            if _key == "quantize_act" and a_scale is None:
                counts["quantize_act_absmax"] += 1
            return _orig(*args, **kw)
        monkeypatch.setattr(cuda_kernels, name, wrapper)
    return counts


def _small_multi():
    from tpu_pose_torch.models import cpm as cpm_lib
    from tpu_pose_torch.utils.config import CPMConfig
    cfg = CPMConfig(input_size=64, features=16, stage1_head_width=32,
                    refine_width=16, num_stages=3, compute_dtype="float32")
    return cfg, cpm_lib.init_cpm_params(0, cfg, device="cpu")


MULTI_B1 = {"plain": dict(), "refine_scale": dict(refine_scale=True),
            "flip": dict(flip_tta=True),
            "refine_scale_flip": dict(refine_scale=True, flip_tta=True),
            "hints": dict(hints=True),
            "hint_crop": dict(hints=True, hint_crop=True),
            "hint_crop_flip": dict(hints=True, hint_crop="all",
                                   flip_tta=True),
            "hint_crop_without_hints": dict(hint_crop=True)}


@pytest.mark.parametrize("case", sorted(MULTI_B1))
def test_multi_b1_launches_match_a_counted_run(counted, case):
    """B1 per estimate_2d_multi call: the hypotheses' decode, one more with
    a crop pass (refine_scale, or hint_crop with hints; hint_crop alone
    does nothing), all twice with flip TTA."""
    from tpu_pose_torch.models import cpm as cpm_lib
    kw = dict(MULTI_B1[case])
    cfg, cpm = _small_multi()
    if kw.pop("hints", False):
        kw["center_hints"] = torch.tensor([[[20.0, 30.0], [44.0, 30.0]]] * 2)
    with torch.no_grad():
        cpm_lib.estimate_2d_multi(cpm, torch.zeros(2, 64, 64, 3), cfg, **kw)
    crop = bool(kw.get("refine_scale")) or (
        bool(kw.get("hint_crop")) and "center_hints" in kw)
    assert counted["soft_argmax"] == chip_smoke.multi_b1_launches(
        crop, bool(kw.get("flip_tta")))


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("people,crop", [(2, False), (3, False), (2, True)])
def test_int8_launches_multi_match_a_counted_run(counted, monkeypatch,
                                                 people, crop, dynamic):
    """B2 per int8 estimate_2d_multi call, computed by int8_launches with
    stage 1 and the refinement trunk at the batch, the refinement stages at
    batch·people, and the crop pass's whole network at batch·people: equal
    to the calls the wrappers count. A small tile budget splits the convs
    into several tiles, whole images and runs of rows."""
    from tpu_pose_torch.models import cpm as cpm_lib
    from tpu_pose_torch.ops import quantize as quantize_lib
    monkeypatch.setattr(quantize_lib, "TILE_BYTES", 10 ** 6)
    cfg, cpm = _small_multi()
    q = cpm_lib.quantize_params(cpm, None if dynamic else {
        name: 0.05 for name, *_ in cpm_lib._layer_defs(cfg)})
    frames = torch.from_numpy(chip_smoke.two_people_frames(2, 64, 64, 0))
    with torch.no_grad():
        cpm_lib.estimate_2d_multi(q, frames, cfg, max_people=people,
                                  refine_scale=crop)
    want = chip_smoke.int8_launches(q, cfg, 2, dynamic, people=people,
                                    crop=crop)
    assert {k: counted[k] for k in want} == want
    monkeypatch.setattr(quantize_lib, "TILE_BYTES", 2 ** 40)
    whole = chip_smoke.int8_launches(q, cfg, 2, dynamic, people=people,
                                     crop=crop)
    assert want["quantize_im2col"] > whole["quantize_im2col"]


def test_extras_fit_cfg_is_the_default_schedule_with_the_extras():
    """fit_extras_main_path's fit: the default stages as L-BFGS stages,
    the interpenetration term on exactly the stages that optimize the
    body pose."""
    from tpu_pose_torch.utils.config import FitConfig
    cfg = chip_smoke.extras_fit_cfg()
    default = FitConfig()
    assert cfg.optimizer == "lbfgs"
    assert len(cfg.stages) == len(default.stages)
    for got, want in zip(cfg.stages, default.stages):
        assert got.iters == want.iters and got.opt_pose == want.opt_pose
        assert got.w_interpenetration == (
            chip_smoke.W_INTERPENETRATION if want.opt_pose else 0.0)


@pytest.mark.parametrize("int8", [False, True])
def test_served_batch_launches_match_a_counted_run(counted, monkeypatch,
                                                   int8):
    """B1 and B2 per served batch, as serving_b1_per_batch and
    serving_b2_launches compute them, equal the calls the wrappers count
    when a BatchingServer runs a burst and a lone request on a small
    estimator (int8: static scales, int8_min_batch 4, microbatch 4, a
    small tile budget)."""
    import numpy as np
    from tpu_pose_torch import serving
    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.ops import quantize as quantize_lib
    from tpu_pose_torch.utils.config import FitConfig, StageConfig
    monkeypatch.setattr(quantize_lib, "TILE_BYTES", 10 ** 6)
    cfg, _ = _small_multi()
    frames = chip_smoke.two_people_frames(8, 64, 64, 0)
    kw = dict(quantize=True, calibration_images=frames[:4],
              int8_min_batch=4, cpm_microbatch=4) if int8 else {}
    est = PoseEstimator.create_synthetic(
        0, cfg, FitConfig(stages=(StageConfig(iters=2),), img_size=64),
        device="cpu", **kw)
    with serving.BatchingServer(est, max_batch=8, max_wait_ms=500.0) as srv:
        for burst in (frames, frames[:1]):
            for k in counted:
                counted[k] = 0
            for f in srv.submit_many(burst):
                f.result(timeout=120)
            bucket = len(burst)
            want = {"soft_argmax": chip_smoke.serving_b1_per_batch(
                bucket, est.cpm_microbatch)}
            if int8:
                want.update(chip_smoke.serving_b2_launches(
                    est.cpm, cfg, bucket, est.cpm_microbatch,
                    est.int8_min_batch))
            assert {k: counted[k] for k in want} == want, bucket
    assert srv.stats.snapshot()["batches"] == 2


def test_cpm_to_coco_round_trips_through_coco_to_cpm():
    """serving_fit's detector joints: CPM-14 into COCO-17 slots, back
    through coco_to_cpm, give the same joints except the neck, which
    becomes the shoulders' midpoint with their lower confidence."""
    import numpy as np
    from tpu_pose_torch.models import joints as joints_lib
    rng = np.random.RandomState(0)
    j14 = rng.rand(3, 14, 2).astype(np.float32)
    c14 = rng.rand(3, 14).astype(np.float32)
    coco, ccoco = chip_smoke.cpm_to_coco(j14, c14)
    assert coco.shape == (3, 17, 2) and ccoco.shape == (3, 17)
    back, cback = joints_lib.coco_to_cpm(coco, ccoco)
    keep = [i for i in range(14) if i != 1]
    np.testing.assert_array_equal(back[:, keep], j14[:, keep])
    np.testing.assert_array_equal(cback[:, keep], c14[:, keep])
    np.testing.assert_allclose(back[:, 1], (j14[:, 2] + j14[:, 5]) / 2)
    np.testing.assert_array_equal(cback[:, 1],
                                  np.minimum(c14[:, 2], c14[:, 5]))


def test_source_frame_bounds_are_the_letterboxed_network_frame():
    """Where a served joint can land in a source frame: the network frame
    mapped back through the letterbox's affine; the frame itself when it
    is network-sized."""
    import numpy as np
    from tpu_pose_torch.ops import preprocess as pre
    assert np.allclose(chip_smoke.source_frame_bounds(368, 368, 368),
                       (0, 0, 368, 368))
    x0, y0, x1, y1 = chip_smoke.source_frame_bounds(480, 640, 368)
    a = pre.letterbox_affine(480, 640, 368)
    np.testing.assert_allclose([x0 * a[0] + a[2], y1 * a[1] + a[3]],
                               [0, 368], atol=1e-4)
    assert y0 < 0 and y1 > 480 and np.isclose(x0, -a[2] / a[0])


# -- training and evaluation phases ------------------------------------------

def _small_train():
    from tpu_pose_torch.data import synthetic
    from tpu_pose_torch.models import cpm_train, smpl_data
    cfg, _ = _small_multi()
    model = smpl_data.synthetic_smpl(seed=0, num_verts=300, device="cpu")
    batch = next(synthetic.cpm_train_batches(model, 2, 1, cfg, seed=0,
                                             raw_images=True))
    cpm, st, opt = cpm_train.init_train_state(0, cfg, lr=1e-3,
                                              total_steps=10, device="cpu")
    return cfg, batch, cpm, st, opt


def test_train_step_launches_no_kernel(counted):
    """train_main_path's check: a train step (loss, gradients, optimizer)
    calls no kernel wrapper; its first scheduled step leaves the loss."""
    cfg, batch, cpm, st, opt = _small_train()
    cpm, st, losses = chip_smoke.train_losses(cpm, st, opt, [batch] * 3,
                                              cfg, fake_quant=True)
    assert all(n == 0 for n in counted.values())
    assert losses[1] == losses[0] and st["count"] == 3


def test_train_state_equal_and_int8_view_helpers():
    """train_state_equal sees a change in any moment; the int8 weights
    quantize_params makes equal the fake-quant view, and a changed int8
    weight is named."""
    import copy
    from tpu_pose_torch.models import cpm as cpm_lib
    cfg, batch, cpm, st, opt = _small_train()
    cpm, st, _ = chip_smoke.train_losses(cpm, st, opt, [batch] * 2, cfg)
    twin, twin_st = copy.deepcopy(cpm), copy.deepcopy(st)
    assert chip_smoke.train_state_equal(cpm, st, twin, twin_st)
    twin_st["nu"]["Mconv5_stage2.bias"][0] += 1e-9
    assert not chip_smoke.train_state_equal(cpm, st, twin, twin_st)
    q = cpm_lib.quantize_params(cpm)
    assert chip_smoke.int8_matches_fake_quant(q, cpm) == []
    with torch.no_grad():
        q.conv3_stage1.w_int8[0, 0] += 1
    assert chip_smoke.int8_matches_fake_quant(q, cpm) == ["conv3_stage1"]


def test_eval_metrics_gap_bounds():
    want = {"mpjpe_p1": 0.10, "pckh": 0.5, "num_frames": 4, "per": {}}
    ok = chip_smoke.eval_metrics_gap(
        {"mpjpe_p1": 0.1009, "pckh": 0.5 + 1 / 56, "num_frames": 4,
         "per": {}}, want, 4)
    assert ok["ok"] and set(ok["gap"]) == {"mpjpe_p1", "pckh", "num_frames"}
    for bad in ({"mpjpe_p1": 0.1011}, {"pckh": 0.5 + 2 / 56},
                {"num_frames": 5}):
        assert not chip_smoke.eval_metrics_gap({**want, **bad}, want,
                                               4)["ok"]
    assert not chip_smoke.eval_metrics_gap({"pckh": 0.5}, want, 4)["ok"]


@pytest.mark.parametrize("int8", [False, True])
def test_eval_launches_match_a_counted_run(counted, monkeypatch, int8):
    """eval_main_path's expected counts: evaluate_pckh over two batches of
    4 on a small estimator (int8: static scales, cpm_microbatch 2, a
    small tile budget) calls the wrappers eval_launches × 2 times; so
    does evaluate_h36m_style on the bf16 one."""
    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.data import synthetic
    from tpu_pose_torch.ops import quantize as quantize_lib
    from tpu_pose_torch.parallel import eval as eval_lib
    from tpu_pose_torch.utils.config import FitConfig, StageConfig
    monkeypatch.setattr(quantize_lib, "TILE_BYTES", 10 ** 6)
    cfg, _ = _small_multi()
    frames = chip_smoke.two_people_frames(4, 64, 64, 0)
    kw = dict(quantize=True, calibration_images=frames, int8_min_batch=2,
              cpm_microbatch=2) if int8 else {}
    est = PoseEstimator.create_synthetic(
        0, cfg, FitConfig(stages=(StageConfig(iters=2),), img_size=64),
        device="cpu", **kw)
    batches = list(synthetic.eval_batches(est.smpl_model, 4, 2, cfg))
    per_chunk = chip_smoke.int8_launches(est.cpm, cfg, 2, False) \
        if int8 else {}
    bf16, q8 = chip_smoke.eval_launches(per_chunk, 4, 2)
    runs = [(eval_lib.evaluate_pckh, q8 if int8 else bf16)]
    if not int8:
        runs.append((eval_lib.evaluate_h36m_style, bf16))
    for evaluate, per_batch in runs:
        for k in counted:
            counted[k] = 0
        evaluate(est, iter(batches))
        assert {k: counted[k] for k in per_batch} == {
            k: 2 * n for k, n in per_batch.items()}


# -- the hard set and its tools (ROADMAP A.19b) ------------------------------

def _small_est(**kw):
    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.utils.config import FitConfig, StageConfig
    cfg, _ = _small_multi()
    return cfg, PoseEstimator.create_synthetic(
        0, cfg, FitConfig(stages=(StageConfig(iters=2),), img_size=64),
        device="cpu", **kw)


@pytest.mark.parametrize("rung", [r[0] for r in
                                  chip_smoke.selfcheck_e2e.HARD_LADDER])
def test_front_end_b1_launches_match_a_counted_run(counted, rung):
    """B1 (and, on the int8 rung, B2) per estimate_and_fit call of each
    selfcheck ladder rung, as front_end_b1_launches and int8_launches
    compute them, equal the wrappers' counted calls on a small estimator;
    the front-end phase's 12 is the same formula's."""
    import numpy as np
    _, _, _, kw = next(r for r in chip_smoke.selfcheck_e2e.HARD_LADDER
                       if r[0] == rung)
    kw = dict(kw)
    frames = chip_smoke.two_people_frames(2, 64, 64, 0)
    if kw.pop("calibrate", False):
        kw["calibration_images"] = frames
    cfg, est = _small_est(**kw)
    for k in counted:
        counted[k] = 0
    est.estimate_and_fit(frames)
    assert counted["soft_argmax"] == chip_smoke.front_end_b1_launches(**kw)
    want = (chip_smoke.int8_launches(est.cpm, cfg, 2, False)
            if kw.get("quantize") else chip_smoke.B2_NONE)
    assert {k: counted[k] for k in want} == want
    assert chip_smoke.front_end_b1_launches(
        **chip_smoke.FRONT_END) == chip_smoke.FRONT_END_B1 == 12
    assert np.isfinite(chip_smoke.front_end_b1_launches(scale_tta=(1.0,)))


@pytest.mark.parametrize("kw", [dict(), dict(hint_passes=2),
                                dict(hint_passes=2, hint_crop=True),
                                dict(temporal_hints=False)])
def test_video_multi_b1_launches_match_a_counted_run(counted, kw):
    """B1 per estimate_and_fit_video_multi call: the NMS pass, then per
    hint pass the hinted decode and its crop with hint_crop."""
    _, est = _small_est()
    est.estimate_and_fit_video_multi(
        chip_smoke.two_people_frames(4, 64, 64, 0), nms_radius_px=32.0, **kw)
    assert counted["soft_argmax"] == chip_smoke.video_multi_b1_launches(**kw)


@pytest.fixture
def cpu_phases(monkeypatch, counted, tmp_path):
    """chip_smoke's hard-set phases rehearsed on the CPU: the small CPM and
    fit for every estimator the phases and tools build, the 300-vertex
    SMPL, the selfcheck's depth cut to a few steps and frames, outputs in
    a temporary directory, launches counted by the wrappers' calls."""
    import dataclasses
    from tpu_pose_torch import api as api_lib
    from tpu_pose_torch.models import smpl_data
    from tpu_pose_torch.tools import selfcheck_e2e
    from tpu_pose_torch.utils.config import FitConfig, StageConfig
    cfg, _ = _small_multi()
    fit = FitConfig(stages=(StageConfig(iters=2),), img_size=64)

    def setup(device):
        return cfg, fit, smpl_data.synthetic_smpl(seed=0, num_verts=300,
                                                  device=device)

    monkeypatch.setattr(selfcheck_e2e, "default_setup", setup)
    real = api_lib.PoseEstimator.create_synthetic.__func__

    def create(cls, seed=0, cpm_cfg=None, fit_cfg=None, **kw):
        return real(cls, seed, cfg, dataclasses.replace(
            fit_cfg or FitConfig(), stages=fit.stages, img_size=64), **kw)

    monkeypatch.setattr(api_lib.PoseEstimator, "create_synthetic",
                        classmethod(create))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "zero_counts",
                        lambda: counted.update(dict.fromkeys(counted, 0)))
    monkeypatch.setattr(chip_smoke, "read_counts", lambda: dict(counted))
    for name, value in dict(
            DEVICE="cpu", MAIN_CPM=cfg, HARD_DATA_FRAMES=3, TRACK_FRAMES=12,
            SWEEP_GRID="plain:12:1:0.0,union:12:1:0.35:0:0:1:2",
            SC_ARGS=["--steps", "4", "--hard_steps", "4", "--train_batch",
                     "2", "--hard_pool", "2", "--eval_frames", "2",
                     "--hard_eval_frames", "2", "--video_frames", "3"],
            SC_DEPTH=dict(EASY_POOL=2, HEAD_STEPS=3, HEAD_BATCH=8,
                          PRIOR_CORPUS=200, MULTI_FRAMES=2,
                          HARD_VIDEO_FRAMES=4, EMPTY_FRAMES=4,
                          COUNT_FRAMES=2, CAL_FRAMES=2),
            SC_OUT=str(tmp_path / "sc"), SWEEP_OUT=str(tmp_path / "sweep"),
            DEMO_OUT=str(tmp_path / "demo")).items():
        monkeypatch.setattr(chip_smoke, name, value)
    return counted


def test_hard_set_phases_run_with_the_computed_launches(cpu_phases):
    """The six hard-set phases, in main's order, at a small size on the
    CPU: every check inside them passes, the launch counts included
    (SELFCHECK_B1 and front_end_b1_launches per section and rung,
    int8_launches on the int8 rung, track_bench's 2 per call or window,
    the sweep's 5 per row, the tools' one per image call)."""
    chip_smoke.phase_hard_data_check()
    npz, sc = chip_smoke.phase_selfcheck_main_path()
    assert set(sc) == set(chip_smoke.SELFCHECK_B1) | {
        r[0] for r in chip_smoke.selfcheck_e2e.HARD_LADDER}
    assert sc["hard_rc_int8_calibrated"]["quantize_im2col"] > 0
    tb = chip_smoke.phase_track_bench_main_path(npz)
    assert tb["enterleave"]["soft_argmax"] == 2 * 2    # 12 frames, 2 windows
    assert chip_smoke.phase_hard_sweep_main_path()["soft_argmax"] == 10
    tools = chip_smoke.phase_tools_main_path()
    assert tools["profile_fit_smpl"]["soft_argmax"] == 0
    chip_smoke.phase_hard_small_reference()


def test_main_runs_every_phase():
    """main() calls every phase_* function the script defines, itself or
    through phase_parallel_main_path or phase_export_new_paths, which it
    runs in processes of their own."""
    import inspect
    body = "".join(inspect.getsource(f) for f in (
        chip_smoke.main, chip_smoke.phase_parallel_main_path,
        chip_smoke.phase_export_new_paths))
    phases = [n for n, f in vars(chip_smoke).items()
              if n.startswith("phase_") and inspect.isfunction(f)]
    assert len(phases) > 40
    assert [p for p in phases if f"{p}(" not in body] == []


def test_hard_set_helpers():
    """_sum_counts adds by kernel; _finite_tree walks nested results."""
    assert chip_smoke._sum_counts([{"soft_argmax": 1}, {"soft_argmax": 2,
                                                        "quantize_act": 3}]
                                  ) == {"soft_argmax": 3, "quantize_act": 3,
                                        "quantize_act_absmax": 0,
                                        "quantize_im2col": 0}
    assert chip_smoke._finite_tree({"a": 1.0, "b": {"c": True, "d": 2}})
    assert not chip_smoke._finite_tree({"a": {"b": float("nan")}})


def test_demo_files_accept_the_npy_fallback(tmp_path):
    (tmp_path / "pose2d_000.png.npy").write_bytes(b"")
    (tmp_path / "fits.npz").write_bytes(b"")
    assert chip_smoke._demo_files(str(tmp_path), [
        "pose2d_000.png", "fits.npz", "mesh_000.obj"]) == ["mesh_000.obj"]


# -- the deployment-artifact phases, rehearsed on the CPU ---------------------

# Where each kernel's op runs its plain version on a CPU tensor: one call
# there is one launch on the card, from a live call or a loaded artifact
# alike (an export's trace runs the fake implementations instead).
OP_PLAIN = {"soft_argmax": ("softargmax_lib", "soft_argmax"),
            "quantize_act": ("quantize_lib", "_quantize"),
            "quantize_act_absmax": ("quantize_lib", "act_scale"),
            "quantize_im2col": ("quantize_lib", "quantize_im2col")}


@pytest.fixture
def cpu_export(monkeypatch, tmp_path):
    """chip_smoke's export phases on the CPU: the small CPM, a short fit,
    short stream windows, artifacts in a temporary directory, launches
    counted where the custom ops run their plain versions (so a loaded
    artifact's calls count as the live path's do)."""
    import types
    from tpu_pose_torch.fitting import temporal
    from tpu_pose_torch.ops import cuda_kernels
    from tpu_pose_torch.utils.config import FitConfig, StageConfig
    counts = dict.fromkeys(OP_PLAIN, 0)
    for lib in ("softargmax_lib", "quantize_lib"):
        real = getattr(cuda_kernels, lib)
        proxy = types.SimpleNamespace(**{
            n: getattr(real, n) for n in dir(real) if not n.startswith("__")})
        for key, (where, name) in OP_PLAIN.items():
            if where == lib:
                def counting(*a, _f=getattr(real, name), _k=key, **kw):
                    counts[_k] += 1
                    return _f(*a, **kw)
                setattr(proxy, name, counting)
        monkeypatch.setattr(cuda_kernels, lib, proxy)
    cfg, _ = _small_multi()
    # One stage: an export traces one gradient graph per stage.
    fit = FitConfig(stages=(StageConfig(iters=3, lr=0.02),), img_size=64)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "zero_counts",
                        lambda: counts.update(dict.fromkeys(counts, 0)))
    monkeypatch.setattr(chip_smoke, "read_counts", lambda: dict(counts))
    for name, value in dict(
            DEVICE="cpu", MAIN_CPM=cfg, EXPORT_OUT=str(tmp_path / "x"),
            EXPORT_FIT=temporal.warmstart_schedule(fit, 3),
            EXPORT_STREAM_CHUNK=3, EXPORT_STREAM_T=7,
            EXPORT_LOAD_LIMIT_S=float("inf")).items():
        monkeypatch.setattr(chip_smoke, name, value)
    return cfg, fit


def test_export_phases_run_with_the_computed_launches(cpu_export,
                                                      monkeypatch):
    """The main-path artifact, the served artifact, the fit_smpl and
    multi-person artifacts and the int8 artifact, on the CPU at a small
    size: every check inside the phases passes (section 8's rule against
    the live calls, one B1 per artifact call and served batch, int8's B2
    launches as int8_launches computes them)."""
    from tpu_pose_torch.api import PoseEstimator
    cfg, fit = cpu_export
    est = PoseEstimator.create_synthetic(seed=0, cpm_cfg=cfg, fit_cfg=fit,
                                         device="cpu")
    images = chip_smoke._frames(2, 64, 64, seed=0)
    prog, launches = chip_smoke.phase_export_main_path(est, images)
    assert launches["soft_argmax"] == 1
    assert chip_smoke.phase_serving_artifact(prog)["soft_argmax"] == 1
    est_x = chip_smoke.export_estimator_of(est)
    assert chip_smoke.phase_export_fit_smpl(est_x)["soft_argmax"] == 0
    chip_smoke.phase_export_multi(est_x, chip_smoke.two_people_frames(
        2, 64, 64, seed=64))
    est8 = PoseEstimator.create_synthetic(
        seed=0, cpm_cfg=cfg, fit_cfg=fit, quantize=True,
        calibration_images=images, cpm_microbatch=2, int8_min_batch=1,
        device="cpu")
    per_chunk = chip_smoke.int8_launches(est8.cpm, cfg, 2, False)
    monkeypatch.setattr(chip_smoke, "INT8_CHUNK", 2)
    got = chip_smoke.phase_export_int8(
        est8, chip_smoke._frames(4, 64, 64, seed=2), per_chunk)
    assert got["quantize_im2col"] == 2 * per_chunk["quantize_im2col"] > 0



# -- the parity harness, the TF converter and their CLIs, on the CPU ---------

def test_fabricated_reference_loads_back(tmp_path):
    """fabricate_reference's three files are what discover_assets and the
    loaders expect: the npz loads as the CPM it was made from, the pickle
    in the real SMPL schema as the same model (also through the JAX
    package's loader), the GMM pickle as a prior."""
    import numpy as np
    from tpu_pose.models import smpl_data as jax_smpl_data
    from tpu_pose_torch.fitting import priors
    from tpu_pose_torch.models import cpm as cpm_lib
    from tpu_pose_torch.models import smpl_data
    from tpu_pose_torch.parity import day_one
    from tpu_pose_torch.utils import tf_converter
    cfg, _ = _small_multi()
    model = smpl_data.synthetic_smpl(seed=0, num_verts=300, device="cpu")
    params = cpm_lib.cpm_params_to_numpy(cpm_lib.init_cpm_params(
        0, cfg, device="cpu"))
    ref = str(tmp_path / "ref")
    chip_smoke.fabricate_reference(ref, model, params)
    assets = day_one.discover_assets(ref)
    assert assets["files_seen"] == 3 and assets["ckpt"] is None
    got = tf_converter.load_params_npz(assets["cpm_npz"])
    assert set(got) == set(params)
    assert all(np.array_equal(got[k][kind], params[k][kind])
               for k in params for kind in ("w", "b"))
    want = model.to_numpy()
    for loaded in (smpl_data.load_smpl_pickle(assets["smpl_pkl"],
                                              device="cpu").to_numpy(),
                   {k: np.asarray(v) for k, v in jax_smpl_data
                    .load_smpl_pickle(assets["smpl_pkl"])._asdict()
                    .items()}):
        for k, v in want.items():
            np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    gmm = priors.load_gmm_pickle(assets["gmm_pkl"], device="cpu")
    assert tuple(gmm.precisions.shape) == (8, 69, 69)


def _phase_lines(out: str) -> dict:
    import json
    lines = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    return {d["phase"]: d for d in lines if "phase" in d}


@pytest.fixture
def cpu_parity(monkeypatch, counted):
    """chip_smoke's parity phases on the CPU: the small CPM for the
    fabricated weights and the day-one chain, the 400-vertex SMPL, one
    certification frame and one smoke-eval batch, a two-axis sweep,
    launches counted by the wrappers' calls."""
    import functools
    from tpu_pose_torch.parity import day_one, sweep
    cfg, _ = _small_multi()
    axes = sweep.default_axes()
    monkeypatch.setattr(sweep, "default_axes", lambda: {
        k: axes[k] for k in ("gmof_sigma", "w_pose_scale")})
    monkeypatch.setattr(day_one, "run_day_one", functools.partial(
        day_one.run_day_one, cpm_cfg=cfg))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "zero_counts",
                        lambda: counted.update(dict.fromkeys(counted, 0)))
    monkeypatch.setattr(chip_smoke, "read_counts", lambda: dict(counted))
    for name, value in dict(
            DEVICE="cpu", MAIN_CPM=cfg, DAY_ONE_VERTS=400,
            DAY_ONE_ARGS=["--frames", "1", "--eval_frames", "4"],
            PARITY_SWEEP_ARGS=["--sweep", "--frames", "1", "--passes", "1",
                               "--oracle_sigma", "40", "--verts",
                               "400"]).items():
        monkeypatch.setattr(chip_smoke, name, value)
    return counted


def test_day_one_phase_runs_the_cli(cpu_parity, capsys):
    """day_one_main_path on the CPU: the day-one CLI's main on the
    fabricated reference exits 0, certified within 1 mm and the
    stage-parity bounds, one B1 per smoke-eval batch; its line carries
    the verdict, the sections' seconds and the L-BFGS counts."""
    counts = chip_smoke.phase_day_one_main_path()
    assert counts["soft_argmax"] == 1
    line = _phase_lines(capsys.readouterr().out)["day_one_main_path"]
    assert line["exit_code"] == 0 and line["ok"] and line["certified"]
    assert line["missing"] == [] and line["fit_gap_mm_mean"] <= 1.0
    assert line["b1_per_smoke_eval_batch"] == 1.0
    assert chip_smoke.stage_parity_ok(line["stage_parity"])
    assert {"discover", "load", "certify", "smoke_eval", "certify_our_fit",
            "certify_oracle_polish",
            "certify_oracle_fit"} <= set(line["sections_s"])
    assert line["lbfgs"]["host_reads"] > 0


def test_parity_sweep_phase_runs_the_cli(cpu_parity, capsys):
    """parity_sweep_main_path on the CPU: the sweep CLI's best gap no
    worse than its first, no kernel launched (no CPM runs)."""
    counts = chip_smoke.phase_parity_sweep_main_path()
    assert counts["soft_argmax"] == 0
    line = _phase_lines(capsys.readouterr().out)["parity_sweep_main_path"]
    assert line["best_gap_mm"] <= line["trajectory_mm"][0] + 1e-9
    assert line["evals"] >= 3 and line["seconds_per_eval"] > 0


def test_tf_converter_check_states_its_skip(monkeypatch, capsys):
    """Where tensorflow does not import, tf_converter_check prints its one
    stated line and nothing else (the phase itself runs in
    tests/test_torch_tf_parity.py, with the TensorFlow tests)."""
    import importlib.util
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "tensorflow" else real(name, *a)))
    import json
    want = {"phase": "tf_converter_check",
            "skipped": "tensorflow is not installed"}
    assert chip_smoke.phase_tf_converter_check() == want
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line.pop("t_s") >= 0 and line == want


def test_stage_parity_bounds_are_test_parity_s():
    """STAGE_PARITY_BOUNDS holds tests/test_parity.py's bounds; a report
    passes at them and fails above any one."""
    report = dict(chip_smoke.STAGE_PARITY_BOUNDS)
    assert chip_smoke.stage_parity_ok(report)
    for k in report:
        assert not chip_smoke.stage_parity_ok(
            dict(report, **{k: report[k] + 1e-3}))


@pytest.mark.parametrize("ok", [True, False])
def test_phase_in_process_returns_its_line(ok, capsys):
    """phase_in_process runs a call of the script in a process of its own;
    finish_process echoes its output and returns its phase line, and
    fails when the process fails."""
    call = ("emit({'phase': 'probe', 'v': 1})" if ok
            else "check(False, 'probe failed')")
    proc = chip_smoke.phase_in_process(call)
    if ok:
        line = chip_smoke.finish_process(proc, "probe", 300)
        assert line["v"] == 1 and line["t_s"] >= 0
        assert '"phase": "probe"' in capsys.readouterr().out
    else:
        with pytest.raises(RuntimeError, match="probe process exited 1"):
            chip_smoke.finish_process(proc, "probe", 300)
    assert proc.poll() is not None


# -- data parallelism over torch.distributed (ROADMAP A.21) -------------------

def test_sharded_b1_launches():
    """B1 per rank per sharded call: one per micro-chunk of the rank's
    rows, one without micro-chunks."""
    assert chip_smoke.sharded_b1_launches(8, 1, 0) == 1
    assert chip_smoke.sharded_b1_launches(8, 2, 0) == 1
    assert chip_smoke.sharded_b1_launches(32, 1, 16) == 2
    assert chip_smoke.sharded_b1_launches(32, 2, 16) == 1
    assert chip_smoke.sharded_b1_launches(8, 1, 3) == 3


def test_video_collectives():
    """Collectives per rank per frame-sharded video call: the outputs'
    gathers; temporal: one more, of the 2D joints; smooth: the lattice
    (or, with one hypothesis, the shared β unless anchored), the mask's
    gather and halo, and per refine step a halo and a shared β's psum.
    tests/test_torch_parallel.py holds it against counted runs at world
    two, test_parallel_phases_run_with_the_computed_launches at one."""
    vc = chip_smoke.video_collectives
    assert vc("independent") == {"gather": 8, "halo": 0, "psum": 0}
    assert vc("temporal", outputs=5) == {"gather": 6, "halo": 0, "psum": 0}
    assert vc("smooth") == {"gather": 9, "halo": 100, "psum": 100}
    assert vc("smooth", iters=30, masked=True, outputs=5) == {
        "gather": 7, "halo": 31, "psum": 30}
    assert vc("smooth", restarts=1, anchored=True) == {
        "gather": 8, "halo": 100, "psum": 100}
    assert vc("smooth", restarts=1, shared_beta=False) == {
        "gather": 8, "halo": 100, "psum": 0}
    assert vc("smooth", restarts=1) == {"gather": 9, "halo": 100,
                                        "psum": 100}


def test_wait_for_file_returns_on_the_flag_or_the_exit(tmp_path):
    """main() starts the other processes once the data-parallel process
    has created its flag after the timed phases, or has exited; a flag
    that never appears fails the run at the timeout, in main() or in the
    process waiting for main()'s go-ahead."""
    flag = str(tmp_path / "timed")
    code = f"import time; open({flag!r}, 'w').close(); time.sleep(60)"
    proc = subprocess.Popen([sys.executable, "-c", code])
    try:
        chip_smoke.wait_for_file(flag, 30, proc)
        assert os.path.exists(flag) and proc.poll() is None
    finally:
        chip_smoke.stop_process(proc)
    chip_smoke.wait_for_file(flag, 0.5)
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    chip_smoke.wait_for_file(str(tmp_path / "never"), 30, proc)
    assert proc.returncode == 0
    proc = subprocess.Popen([sys.executable, "-c", "import time; "
                             "time.sleep(60)"])
    try:
        with pytest.raises(RuntimeError, match="did not appear"):
            chip_smoke.wait_for_file(str(tmp_path / "never"), 0.5, proc)
    finally:
        chip_smoke.stop_process(proc)
    with pytest.raises(RuntimeError, match="did not appear"):
        chip_smoke.wait_for_file(str(tmp_path / "never"), 0.5)


PARALLEL_KEYS = {
    "sharded_main_path": {"s_per_call", "live_s_per_call", "b1_per_call",
                          "all_gather_ms", "all_gather_bytes",
                          "max_d_theta", "live_vs_live_max_d_theta",
                          "deterministic_max_gap"},
    "sharded_eval": {"h36m", "pckh", "batch", "batches", "deterministic"},
    "dp_train_step": {"loss_mesh", "loss_single", "max_param_diff",
                      "s_per_step_mesh", "s_per_step_single",
                      "grad_all_reduce_ms", "grad_all_reduce_bytes"},
    "sharded_export": {"export_s", "load_s", "s_per_call", "b1_per_call",
                       "max_d_joints2d_px", "sharding"},
    "sharded_video": {"s_per_call", "live_s_per_call", "b1_per_call",
                      "collectives_per_call", "collectives_expected",
                      "max_d_theta", "deterministic_max_gap", "modes"},
    "sharded_video_export": {"export_s", "save_s", "load_s", "s_per_call",
                             "live_s_per_call", "b1_per_call",
                             "max_d_theta", "joints3d_mpjpe_mm",
                             "sharding"}}


def test_parallel_phases_run_with_the_computed_launches(cpu_export,
                                                        monkeypatch,
                                                        tmp_path, capsys):
    """sharded_main_path, sharded_eval, dp_train_step, sharded_export,
    sharded_video and sharded_video_export on the CPU in a gloo world of
    one, at a small size: every check inside passes (B1 once per sharded
    call, per evaluated batch and per artifact call; the DP step's loss
    and parameters; the video calls' collectives as video_collectives
    counts them, and equal to the live calls; no B2 anywhere), and each
    prints its keys."""
    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.parallel import mesh as mesh_lib
    cfg, fit = cpu_export
    for name, value in dict(MAIN_BATCH=2, DP_BATCH=2,
                            PARALLEL_OUT=str(tmp_path / "p")).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "eager_ms",
                        lambda fn, reps=60: 1e3 * chip_smoke.host_s(fn))
    est = PoseEstimator.create_synthetic(seed=0, cpm_cfg=cfg, fit_cfg=fit,
                                         device="cpu")
    images = chip_smoke._frames(2, 64, 64, seed=0)
    b1 = {**chip_smoke.B2_NONE, "soft_argmax": 1}
    mesh = mesh_lib.make_mesh(device="cpu")
    try:
        assert chip_smoke.phase_sharded_main_path(est, mesh, images) == b1
        ev = chip_smoke.phase_sharded_eval(est, mesh)
        assert ev == {k: {**chip_smoke.B2_NONE, "soft_argmax": 2}
                      for k in ("h36m", "pckh")}
        assert set(chip_smoke.phase_dp_train_step(mesh).values()) == {0}
        assert chip_smoke.phase_sharded_export(est, mesh, images) == b1
        est_v = PoseEstimator(est.cpm, est.smpl_model, None, cfg, fit,
                              fit_restarts=2, device="cpu")
        video = chip_smoke._frames(3, 64, 64, seed=5)
        assert chip_smoke.phase_sharded_video(est_v, mesh, video) == b1
        assert chip_smoke.phase_sharded_video_export(
            est_v, mesh, video[:2]) == b1
    finally:
        torch.distributed.destroy_process_group()
    lines = _phase_lines(capsys.readouterr().out)
    for phase, keys in PARALLEL_KEYS.items():
        assert keys <= set(lines[phase]), phase
        assert lines[phase]["world_size"] == 1
    assert lines["dp_train_step"]["max_param_diff"] == 0.0
    assert lines["sharded_main_path"]["max_d_theta"] == 0.0
    assert set(lines["sharded_main_path"]["deterministic_max_gap"]
               .values()) == {0.0}
    assert lines["sharded_eval"]["h36m"]["equal"]
    video = lines["sharded_video"]
    assert video["collectives_per_call"] == {"gather": 9, "halo": 100,
                                             "psum": 100}
    assert set(video["deterministic_max_gap"].values()) == {0.0}
    for mode in ("temporal", "independent"):
        assert set(video["modes"][mode]["deterministic_max_gap"]
                   .values()) == {0.0}
