"""PyTorch / CUDA port of ``tpu_pose`` for an NVIDIA H100.

Mirrors the JAX package's module paths and function names
(``tpu_pose_torch/models/cpm.py`` ↔ ``tpu_pose/models/cpm.py``, …) and keeps
its public layouts: images and heatmaps NHWC, joints ``(B, P, 2)``, θ
``(B, 72)``. Imports ``torch`` and numpy only — never JAX and never the
JAX package.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without CUDA and without an explicit device they raise.
"""

_API_EXPORTS = ("PoseEstimator", "estimate_2d", "fit_smpl",
                "estimate_and_fit", "MultiPersonVideoSession",
                "VideoSession")
_SERVING_EXPORTS = {"BatchingServer": "serving",
                    "PoseHTTPServer": "serving_http"}


def __getattr__(name):
    # Lazy, so `import tpu_pose_torch.models.smpl` does not pull the API.
    if name in _API_EXPORTS:
        from tpu_pose_torch import api
        return getattr(api, name)
    if name in _SERVING_EXPORTS:
        import importlib
        module = importlib.import_module(
            f"tpu_pose_torch.{_SERVING_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(name)
