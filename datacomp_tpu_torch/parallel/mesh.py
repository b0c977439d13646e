"""The job's two levels: the ranks of the process group, and the devices
this process drives (counterpart of ``datacomp_tpu/parallel/mesh.py``).

The JAX package has a mesh of the chips inside one process, and processes
over hosts.  Here a rank is what a "host" is in ``parallel/multihost.py``,
and a rank's local devices are what the JAX mesh's chips are: a lone
process takes every visible card (``make_mesh()`` over ``jax.devices()``),
while a rank of a ``torchrun`` job of several ranks keeps its one card
(``cuda:LOCAL_RANK``).  A job has one of the two levels, never both.  The
only axis on either is data parallelism over chunks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This process's place in the job: its rank, the number of ranks, its
    first device, the default group (device collectives: NCCL for CUDA
    tensors), a gloo group over the same ranks (host metadata and
    barriers), and the devices this process drives (``local_devices``, by
    default ``(device,)``; the same card may stand twice).  A mesh of one
    rank without a process group has no groups and runs no collective."""

    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    host_group: Optional[dist.ProcessGroup] = None
    local_devices: tuple = ()

    def __post_init__(self):
        if not self.local_devices:
            object.__setattr__(self, "local_devices", (self.device,))


def rank_device(config=None) -> torch.device:
    """This rank's device by ``config`` (by default the loaded config): the
    CPU under ``force_cpu`` or ``platform="cpu"``, else the CUDA device of
    ``pick_device`` (``cuda:LOCAL_RANK`` under ``torchrun``, unless
    ``device_index`` names one)."""
    from ..config import load_config
    from ..services.gpu_service import pick_device

    cfg = (config or load_config()).device
    return torch.device("cpu") if cfg.force_cpu else pick_device(cfg.platform, cfg.device_index)


def local_devices(config=None) -> tuple:
    """The devices this process drives, by ``config`` (by default the loaded
    config): :func:`rank_device` alone when that is the CPU, when
    ``device_index`` names a card, or in a ``torchrun`` job of several ranks
    (``WORLD_SIZE`` > 1: one card a rank); else, in a lone process, every
    visible card, ``cuda:0`` to ``cuda:{device_count - 1}``.  Raises without
    a CUDA device unless the config selects the CPU."""
    from ..config import load_config

    config = config or load_config()
    cfg = config.device
    one = rank_device(config)  # raises without a CUDA device, as every GPU path does
    if (one.type == "cpu" or cfg.device_index != -1
            or int(os.environ.get("WORLD_SIZE", "1")) > 1):
        return (one,)
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def make_mesh(n: Optional[int] = None, device=None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of every rank of the initialised process group (of this
    process alone when none is), driving ``devices`` (by default
    :func:`local_devices`; ``device`` is one device alone).  ``n``, when
    given, is the number of ranks expected.  Raises when a job of several
    ranks asks for several local devices: a job has one level or the other.
    With a process group this is a collective: every rank calls it (it
    makes the gloo group).  The first device becomes the current CUDA
    device (NCCL's); the others are named by each launch."""
    if devices is None:
        devices = (device,) if device is not None else local_devices()
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one local device")
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    if size > 1 and len(devices) > 1:
        raise ValueError(
            f"a job of {size} ranks drives one device a rank, not {len(devices)}: "
            "run one process alone to use every local device"
        )
    if n is not None and n != size:
        raise ValueError(f"requested {n} ranks, the job has {size}")
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    group = host_group = None
    if dist.is_initialized():
        group, host_group = dist.group.WORLD, dist.new_group(backend="gloo")
    return Mesh(rank, size, devices[0], group, host_group, devices)
