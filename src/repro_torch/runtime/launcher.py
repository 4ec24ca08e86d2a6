"""Cluster launcher (counterpart of ``repro.runtime.launcher``):
Slurm or torchrun environment -> ``torch.distributed`` -> mesh.

SAKURAONE schedules through Slurm (paper §3).  Every process calls
``bootstrap()``, which reads the scheduler's environment (Slurm, else
torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``, in
place of the reference's ``JAX_*`` variables), opens the process group
(NCCL on the card, gloo when the caller asks for the CPU) and returns
the mesh and this process's coordinates.  A single process opens no
process group and gets no mesh: its caller runs the meshless path.

  torchrun --standalone --nproc_per_node 4 -m repro_torch.launch.train --device cpu
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.runtime.serving import resolve_device


@dataclasses.dataclass(frozen=True)
class ClusterEnv:
    coordinator: str
    num_processes: int
    process_id: int
    local_devices: Optional[int] = None
    local_rank: int = 0
    init_method: str = "env://"

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def detect_cluster() -> ClusterEnv:
    """Slurm first (the paper's scheduler), then torchrun's variables,
    else a local run.  Under torchrun the group meets through ``env://``
    (on the agent's store where torchrun keeps one); under Slurm on
    ``tcp://`` at the first node of the step."""
    env = os.environ
    if "SLURM_JOB_ID" in env and "SLURM_NTASKS" in env:
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        head = nodelist.split(",")[0].replace("[", "").split("-")[0] or "localhost"
        port = env.get("REPRO_COORD_PORT", "12345")
        return ClusterEnv(
            coordinator=f"{head}:{port}",
            num_processes=int(env["SLURM_NTASKS"]),
            process_id=int(env.get("SLURM_PROCID", 0)),
            local_rank=int(env.get("SLURM_LOCALID", 0)),
            init_method=f"tcp://{head}:{port}",
        )
    if "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        return ClusterEnv(
            coordinator=f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}",
            num_processes=int(env["WORLD_SIZE"]),
            process_id=int(env.get("RANK", 0)),
            local_rank=int(env.get("LOCAL_RANK", 0)),
        )
    return ClusterEnv(coordinator="localhost:0", num_processes=1, process_id=0)


def bootstrap(*, multi_pod: bool = False, require_chips: Optional[int] = None,
              device=None):
    """Open the process group (if the run is distributed) and build the
    production mesh.  Returns ``(mesh, cluster)``: ``mesh`` None for a
    single process.

    The backend follows the device: NCCL on CUDA (``device`` None or
    ``"cuda"``; each process takes the GPU of its local rank), gloo where
    the caller asked for the CPU.  NCCL never falls back to gloo.

    require_chips: fail fast if the fleet is smaller than expected, the
    launcher-level guard that turns a silently degraded run into a
    restart (the elastic planner then decides the remesh).

    Raises:
      RuntimeError: fewer ranks than ``require_chips``, or CUDA asked for
          (by default) where there is none."""
    cluster = detect_cluster()
    dev = resolve_device(device)
    if cluster.is_distributed and not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(cluster.local_rank)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=cluster.init_method,
            world_size=cluster.num_processes, rank=cluster.process_id)
    n = dist.get_world_size() if cluster.is_distributed else 1
    if require_chips is not None and n < require_chips:
        raise RuntimeError(
            f"fleet has {n} chips < required {require_chips}; "
            "run the elastic planner (repro_torch.runtime.elastic."
            "plan_remesh) or relaunch with more nodes")
    if not cluster.is_distributed:
        return None, cluster
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    if n >= 512 and multi_pod:
        mesh = make_production_mesh(multi_pod=True)
    elif n >= 256:
        mesh = make_production_mesh(multi_pod=False)
    else:
        mesh = make_host_mesh()
    return mesh, cluster


def device_for(cluster: ClusterEnv, device=None) -> torch.device:
    """This process's device: its local rank's GPU on CUDA, else the
    device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", cluster.local_rank)
    return dev
