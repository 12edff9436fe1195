"""Multi-process check of the data-parallel train step (the counterpart of
``scripts/multiprocess_smoke.py``).

The parent starts ``--nproc`` ranks as a launcher does (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` on
localhost, a free port), each building its mesh with
``parallel/mesh.make_mesh()`` from that environment: gloo on the CPU, or
NCCL with one GPU per rank. Every rank takes one data-parallel step
(``models/cpm_train.make_train_step(mesh=)``) on the same global batch
and prints its loss and a digest of its updated parameters. The parent
runs the same step in one process without a mesh and requires every
rank's loss to match it (rtol 1e-5) and every rank's parameters to be
identical to each other's.

  python -m tpu_pose_torch.tools.multiprocess_smoke --device cpu --nproc 2
  python -m tpu_pose_torch.tools.multiprocess_smoke --nproc 1   # one GPU

Exit 0 and ``multiprocess_smoke: OK`` on success, 1 on a mismatch or a
failed rank.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

LOSS_RTOL = 1e-5
PER_RANK = 4
TIMEOUT_S = 600    # seconds to wait for the ranks


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-multiprocess-smoke",
        description="Check the data-parallel train step across processes.")
    p.add_argument("--nproc", type=int, default=2, help="ranks to start")
    p.add_argument("--device", default="cuda", help="cuda (NCCL, one GPU "
                   "per rank) or cpu (gloo)")
    p.add_argument("--child", action="store_true",
                   help="run as one rank (set by the parent)")
    return p.parse_args(argv)


def _setup(device: str, world: int):
    """The small CPM, its fresh train state and the global batch, the same
    on every rank (seeded)."""
    import numpy as np

    from tpu_pose_torch.models import cpm_train
    from tpu_pose_torch.utils.config import CPMConfig

    cfg = CPMConfig(input_size=32, features=8, stage1_head_width=8,
                    refine_width=8, num_stages=2, compute_dtype="float32")
    rng = np.random.RandomState(0)
    b = PER_RANK * world
    batch = {
        "images": rng.rand(b, 32, 32, 3).astype(np.float32) - 0.5,
        "center_maps": rng.rand(b, 32, 32, 1).astype(np.float32),
        "heatmaps": rng.rand(b, 4, 4, 15).astype(np.float32),
    }
    cpm, opt_state, opt = cpm_train.init_train_state(0, cfg, lr=1e-4,
                                                     device=device)
    return cfg, cpm, opt_state, opt, batch


def _step(device: str, world: int, mesh=None) -> dict:
    import hashlib

    import torch

    from tpu_pose_torch.models import cpm_train

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpm, opt_state, opt, batch = _setup(device, world)
    step = cpm_train.make_train_step(cfg, opt, mesh=mesh)
    cpm, _, loss = step(cpm, opt_state, batch)
    h = hashlib.sha256()
    for _, p in sorted(cpm.named_parameters()):
        h.update(p.detach().cpu().numpy().tobytes())
    return {"loss": float(loss), "params_sha256": h.hexdigest()}


def child(args) -> None:
    import torch.distributed as dist

    from tpu_pose_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(device=args.device)
    out = _step(args.device, mesh.size(), mesh)
    out.update(rank=dist.get_rank(), world_size=dist.get_world_size(),
               backend=dist.get_backend())
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parent(args) -> int:
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    procs = []
    for r in range(args.nproc):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(args.nproc), LOCAL_WORLD_SIZE=str(
                       args.nproc), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=path)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpu_pose_torch.tools.multiprocess_smoke",
             "--child", "--device", args.device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:   # the reference while the ranks run
        ref = _step(args.device, args.nproc)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks, failed = [], []
    for r, p in enumerate(procs):
        try:
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            stdout, stderr = p.communicate()
        if p.returncode != 0:
            failed.append({"rank": r, "returncode": p.returncode,
                           "stderr": stderr[-2000:]})
            continue
        ranks.append(json.loads(stdout.strip().splitlines()[-1]))
    ok = (not failed and len(ranks) == args.nproc
          and all(abs(x["loss"] - ref["loss"])
                  <= LOSS_RTOL * abs(ref["loss"]) for x in ranks)
          and len({x["params_sha256"] for x in ranks}) == 1)
    print(json.dumps({"reference_loss": ref["loss"], "ranks": ranks,
                      "failed": failed, "ok": ok}), flush=True)
    print("multiprocess_smoke: " + ("OK" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.child:
        child(args)
        return 0
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
