"""Process-group start-up and host-side work sharding (port of
gpd_tpu/parallel/multihost.py).

gpd_tpu starts ``jax.distributed`` and each process drives its local
devices. The port runs one process per device: ``initialize`` joins this
process to a ``torch.distributed`` group, NCCL when its device is a card
(``cuda:LOCAL_RANK``) and gloo on the CPU, so ``process_info`` always
reports one local device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from gpd_tpu_torch import resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None) -> torch.device:
    """Join the process group from the arguments or torchrun's environment
    (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).

    ``coordinator_address`` is ``host:port`` (a TCP store on rank 0) or an
    init URL (``tcp://...``, ``file://...``). ``device`` is CUDA unless the
    caller names the CPU, as for every entry point of the port; on CUDA the
    process takes card LOCAL_RANK (else its rank modulo the visible cards)
    and NCCL, on the CPU gloo. Returns the process's device.

    NCCL's async error handling stays as the environment sets it: PyTorch's
    CUDA-graph notes turn it off to capture a DDP step whole, but the
    card's torch (2.11 with NCCL 2.28.9) captures and replays ``fit``'s DDP
    step with it on (its default), and on it keeps aborting the
    collectives of a lost rank rather than leaving them hung."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    world = int(num_processes if num_processes is not None
                else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=world, rank=rank)
    return device


def process_info():
    """(process_index, process_count, local_device_count): one device per
    process; (0, 1, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1, 1
    return dist.get_rank(), dist.get_world_size(), 1


def shard_work(items, process_index: Optional[int] = None,
               process_count: Optional[int] = None):
    """Round-robin shard a host-side work list across processes."""
    pi, pc, _ = process_info()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % pc == pi]
