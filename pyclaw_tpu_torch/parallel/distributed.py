"""Multi-process bootstrap: the MPI_Init / PETSc-comm-world equivalent.

Counterpart of ``pyclaw_tpu/parallel/distributed.py`` (``init_distributed
:35-93``, ``process_index``, ``process_count``, ``is_main_process``).
The port runs one process per rank, PetClaw's own MPI model, on
``torch.distributed``: NCCL when the ranks compute on CUDA cards, one
card a rank, and ``gloo`` otherwise.  A launcher sets the triple
(``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` and ``LOCAL_RANK``), as the JAX package reads
``JAX_COORDINATOR_ADDRESS``:

    torchrun --nproc-per-node 4 -m pyclaw_tpu_torch.examples.euler_3d \\
        use_parallel=True mx=192 my=192 mz=192

or the program passes it: ``init_distributed(backend="gloo",
init_method="tcp://localhost:29500", world_size=4, rank=r)``.  Every
process then runs the same program; IO and logging are gated by
:func:`is_main_process`.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from ..config import default_device

logger = logging.getLogger("pyclaw.controller")

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(backend=None, init_method=None, world_size=None,
                     rank=None, device=None):
    """Join the process group (idempotent); returns ``(process_index,
    process_count)``.

    With no arguments the triple comes from the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); a single
    process with none of it set is a no-op that returns ``(0, 1)``.  A
    partial triple raises.  ``backend`` defaults to NCCL when the ranks'
    ``device`` (default :func:`pyclaw_tpu_torch.config.default_device`)
    is a CUDA card and to ``gloo`` otherwise.  An NCCL rank gets
    ``cuda:LOCAL_RANK`` as its current card (``rank`` modulo the cards of
    its host when no launcher set ``LOCAL_RANK``)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    given = (init_method, world_size, rank)
    if any(v is not None for v in given):
        if any(v is None for v in given):
            raise ValueError(
                "init_distributed: init_method, world_size and rank go "
                "together: give all three or none (then the launcher's "
                "RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT)")
    else:
        have = [k for k in _ENV if os.environ.get(k)]
        if not have:
            return 0, 1
        if len(have) != len(_ENV):
            missing = [k for k in _ENV if k not in have]
            raise ValueError(
                f"init_distributed: {', '.join(have)} set but not "
                f"{', '.join(missing)}: a launcher sets the whole triple "
                "(torchrun does), a single process none of it")
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if backend is None:
        dev = torch.device(default_device() if device is None else device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else
                              int(rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    info = (dist.get_rank(), dist.get_world_size())
    logger.info("distributed init (%s): process %d of %d", backend, *info)
    return info


def process_index():
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process():
    return process_index() == 0
