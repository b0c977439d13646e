"""The ranks of a job, one device each (counterpart of
``datacomp_tpu/parallel/mesh.py``).

The JAX package has two levels: a mesh of the chips inside one process, and
processes over hosts.  Here one process drives one GPU, as ``torchrun``
starts them, so both levels are the ranks of the process group: a rank is
what a "host" is in ``parallel/multihost.py``, and the only cross-rank axis
is still data parallelism over chunks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This process's place in the job: its rank, the number of ranks, its
    device, the default group (device collectives: NCCL for CUDA tensors)
    and a gloo group over the same ranks (host metadata and barriers).  A
    mesh of one without a process group has no groups and runs no
    collective."""

    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    host_group: Optional[dist.ProcessGroup] = None


def rank_device(config=None) -> torch.device:
    """This rank's device by ``config`` (by default the loaded config): the
    CPU under ``force_cpu`` or ``platform="cpu"``, else the CUDA device of
    ``pick_device`` (``cuda:LOCAL_RANK`` under ``torchrun``, unless
    ``device_index`` names one)."""
    from ..config import load_config
    from ..services.gpu_service import pick_device

    cfg = (config or load_config()).device
    return torch.device("cpu") if cfg.force_cpu else pick_device(cfg.platform, cfg.device_index)


def make_mesh(n: Optional[int] = None, device=None) -> Mesh:
    """The mesh of every rank of the initialised process group (of this
    process alone when none is), on ``device`` (by default
    :func:`rank_device`).  ``n``, when given, is the number of ranks
    expected.  With a process group this is a collective: every rank calls
    it (it makes the gloo group)."""
    device = torch.device(device) if device is not None else rank_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        group, host_group = dist.group.WORLD, dist.new_group(backend="gloo")
    else:
        rank, size, group, host_group = 0, 1, None, None
    if n is not None and n != size:
        raise ValueError(f"requested {n} ranks, the job has {size}")
    return Mesh(rank, size, device, group, host_group)
