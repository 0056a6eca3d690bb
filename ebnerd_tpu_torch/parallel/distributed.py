"""Multi-process bootstrap and per-process data ownership on
``torch.distributed`` (counterpart of ``ebnerd_tpu/parallel/distributed.py``).

One process per device, PyTorch's idiom. Each process of a job calls

    from ebnerd_tpu_torch.parallel import distributed as dist
    dist.initialize("host0:29500", num_processes=N, process_id=i, device="cuda")
    mesh = make_mesh()                      # (data=N, model=1) over the group
    rows = dist.local_device_slice(n)       # this process's rows of n

The coordinator is ``tcp://host:port`` (a bare ``host:port`` gets the
scheme), or ``EBNERD_COORDINATOR`` when none is passed, as the JAX
function reads it. Nothing on a machine tells a process of its job, so the
process count and index are arguments. The backend is NCCL for a ``cuda``
device and gloo on the CPU; ``backend=`` overrides it.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as tdist

__all__ = ["initialize", "shutdown", "is_distributed", "process_info", "local_device_slice"]

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda", backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` with the JAX function's
    environment fallback. Idempotent, and a no-op when neither a
    coordinator nor a process count is given. Unlike the JAX function, an
    init that fails raises."""
    global _initialized
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get("EBNERD_COORDINATOR")
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None:
        raise ValueError("initialize: a process count needs a coordinator address "
                         "(coordinator_address or EBNERD_COORDINATOR)")
    if num_processes is None or process_id is None:
        raise ValueError("initialize: pass num_processes and process_id")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    tdist.init_process_group(backend, init_method=url, world_size=num_processes,
                             rank=process_id)
    _initialized = True


def shutdown() -> None:
    """Leave the job (``destroy_process_group``); ``initialize`` may then
    join another."""
    global _initialized
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _initialized = False


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def is_distributed() -> bool:
    return process_count() > 1


def process_info() -> dict:
    """This process's index and the job's size; one device per process."""
    n = process_count()
    return {"process_index": process_index(), "process_count": n, "local_devices": 1,
            "global_devices": n,
            "backend": tdist.get_backend() if tdist.is_initialized() else None}


def local_device_slice(n_rows: int) -> slice:
    """Rows of a global dataset owned by this process (contiguous blocks)."""
    from .mesh import host_shard_rows

    return host_shard_rows(n_rows)
