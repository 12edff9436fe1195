"""Data parallelism over ``torch.distributed`` (``mesh``) and dataset-scale
evaluation, on one device or over a mesh (``eval``)."""

from tpu_pose_torch.parallel import eval, mesh  # noqa: F401,A004
from tpu_pose_torch.parallel.mesh import make_mesh, shard_batch  # noqa: F401
