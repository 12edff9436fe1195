"""Input pipelines (port of ``tpu_pose/data/``):

- :mod:`tpu_pose_torch.data.synthetic` — hermetic synthetic pose data:
  sampled SMPL poses rendered to Gaussian-blob images with heatmap, 2D
  and 3D targets, for CPM training and the H3.6M-style evaluation;
- :mod:`tpu_pose_torch.data.pipeline` — batched readers over on-disk npz
  shards, split across ``torch.distributed`` ranks;
- :mod:`tpu_pose_torch.data.datasets` — the LSP, MPII, COCO, H3.6M and
  3DPW readers and their shard converters.

Everything here is numpy on the host; batches reach the device in the
train step and the evaluators.
"""
