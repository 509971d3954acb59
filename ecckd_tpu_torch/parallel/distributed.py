"""Multi-process initialisation helpers.

PyTorch counterpart of ``ecckd_tpu/parallel/distributed.py``.  The reference
has no distributed backend (OpenMP only); the JAX package scales across
hosts with ``jax.distributed`` and a global mesh, and the port with
``torch.distributed`` and the process-major :class:`~.mesh.Mesh`.  Tools run
unchanged under a launcher such as ``torchrun``:

    from ecckd_tpu_torch.parallel import distributed
    distributed.initialize_from_env()   # False (nothing done) in one process

The collectives the port uses are sums (interval and flux partials, g-point
partials, cost and gradient), minima and maxima (g-point min/max), all
through :class:`~.mesh.Mesh`.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch

from .. import logs


def initialize_from_env(backend: Optional[str] = None,
                        init_method: Optional[str] = None,
                        world_size: Optional[int] = None,
                        rank: Optional[int] = None,
                        timeout_s: Optional[float] = None) -> bool:
    """Initialise ``torch.distributed`` from the arguments or torchrun's
    variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), where JAX's reads ``JAX_*``.

    The backend is the caller's, or NCCL where a card is visible and gloo
    otherwise; with NCCL this process's card is ``LOCAL_RANK``'s.  Gloo
    runs several processes on one card (their CUDA tensors are reduced
    through host copies, :func:`.mesh.all_reduce`).  Returns False, having
    done nothing, for a single process; True once the group is up."""
    import torch.distributed as dist

    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None or world_size <= 1:
        return False
    if rank is None:
        raise ValueError("initialize_from_env: WORLD_SIZE > 1 without RANK")
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("initialize_from_env: set MASTER_ADDR and "
                             "MASTER_PORT, or pass init_method")
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)
    logs.log(f"torch.distributed initialized: process {rank}/{world_size}, "
             f"backend {backend}")
    return True


def process_index() -> int:
    """This process's rank in ``torch.distributed``, 0 without a group."""
    import torch.distributed as dist
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The processes of ``torch.distributed``, 1 without a group."""
    import torch.distributed as dist
    return dist.get_world_size() if _initialized() else 1


def _initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def local_shard_range(n_items: int) -> range:
    """This process's contiguous slice of a globally partitioned work list
    (e.g. spectral shard files): the multi-process analogue of the
    reference's one-profile-at-a-time streaming."""
    pid, nproc = process_index(), process_count()
    per = -(-n_items // nproc)
    return range(pid * per, min((pid + 1) * per, n_items))
