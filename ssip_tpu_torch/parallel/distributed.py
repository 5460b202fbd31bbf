"""Process-group bootstrap and the collectives of the data axis.

Counterpart of ``ssip_tpu/parallel/distributed.py:39-84``. The JAX package
is one controller that sees every chip; PyTorch runs one process a card,
joined by ``torch.distributed``. ``initialize()`` reads the same variables
(``SSIP_COORDINATOR``, ``SSIP_NUM_PROCESSES``, ``SSIP_PROCESS_ID``) with the
same no-op cases and the same warning when a coordinator is set without a
process count. It also takes torchrun's ``RANK``/``WORLD_SIZE``/
``LOCAL_RANK`` (with ``MASTER_ADDR``/``MASTER_PORT``): the launcher tells
the process who it is, PyTorch's form of jax's launcher auto-detection
(``process_id=None``). A torchrun launch joins a group even at one process,
so ``--fsdp`` runs its sharded program on one card.

Backend: NCCL when the run is on the card, gloo on the CPU. Each rank runs
on ``cuda:LOCAL_RANK`` (``runtime/device.py``). A process that was started
without a launcher is one rank and joins no group.

The collectives the data-parallel paths share live here too:

- ``synced_batch(group)``: inside the block the masked BatchNorm sums its
  batch statistics and an MoE layer its routing statistics over the group
  (``sync_group()`` reads it), so a step sees the global batch as the JAX
  step does;
- ``all_reduce_sum``: the autograd-aware sum (its backward sums the
  gradients over the ranks, as the statistics feed every rank's loss);
- ``gather_rows``: each rank's equal-sized block, concatenated in rank
  order on every rank.
"""

from __future__ import annotations

import contextvars
import os
from contextlib import contextmanager
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from ssip_tpu_torch.runtime.logging import get_logger

LOGGER = get_logger(__name__)

_SYNC_GROUP: contextvars.ContextVar = contextvars.ContextVar("ssip_sync_group", default=None)


def _launcher_env() -> Optional[tuple]:
    """(rank, world, local rank) when torchrun launched this process."""
    env = os.environ
    if not (env.get("RANK") and env.get("WORLD_SIZE") and env.get("MASTER_ADDR")):
        return None
    rank = int(env["RANK"])
    return rank, int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", rank))


def _init_method(coordinator: str) -> str:
    """``host:port`` → ``tcp://host:port``; a URL (``tcp://``, ``file://``) as given."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "auto",
) -> bool:
    """Join (or skip) the process group. Returns True if distributed.

    No-op when single-process: no launcher, and either no coordinator is
    configured or ``num_processes <= 1``. ``device`` is the CLI's
    ``--device``: ``cpu`` joins over gloo, anything else over NCCL when a
    card is visible. A failed join raises.
    """
    if dist.is_available() and dist.is_initialized():
        return True

    coordinator_address = coordinator_address or os.environ.get("SSIP_COORDINATOR")
    num_processes = num_processes or int(os.environ.get("SSIP_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        env_pid = os.environ.get("SSIP_PROCESS_ID", "") or ""
        process_id = int(env_pid) if env_pid.strip() else None
    launcher = _launcher_env()

    if launcher is None and (not coordinator_address or num_processes <= 1):
        if coordinator_address and num_processes <= 1:
            # a coordinator address is explicit distributed intent — don't
            # let a missing SSIP_NUM_PROCESSES silently fork N independent
            # single-host jobs that clobber shared outputs
            LOGGER.warning(
                "SSIP_COORDINATOR is set (%s) but SSIP_NUM_PROCESSES is %s — "
                "running single-process; set SSIP_NUM_PROCESSES to go "
                "distributed.",
                coordinator_address, num_processes or "unset",
            )
        return False

    if coordinator_address and num_processes > 1:
        if process_id is None:
            if launcher is None:
                raise ValueError(
                    "SSIP_COORDINATOR and SSIP_NUM_PROCESSES are set but this process has no rank: "
                    "set SSIP_PROCESS_ID, or launch it with torchrun"
                )
            process_id = launcher[0]
        rank, world, init_method = process_id, num_processes, _init_method(coordinator_address)
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    else:
        rank, world, local_rank = launcher
        init_method = "env://"

    cuda = device != "cpu" and torch.cuda.is_available()
    backend = "nccl" if cuda else "gloo"
    if cuda:
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    LOGGER.info(
        "Joining process group: %s (%d processes, this is %d, local %d, %s)",
        init_method, world, rank, local_rank, backend,
    )
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    os.environ["LOCAL_RANK"] = str(local_rank)
    return True


def shutdown(clean: bool = True) -> None:
    """Leave the process group, if this process joined one.

    ``clean``: this rank finished its work. Every rank then passes a barrier
    (on NCCL on its own card, on gloo under the group's timeout) before any
    closes its connections: a rank that leaves alone can close them while a
    peer is still joining the group, whose join then fails. A rank leaving
    on an exception passes ``clean=False`` and leaves at once: the barrier
    would wait for a peer that crashed until the group's timeout, and its
    error would hide the first one. A rank whose peer is gone may raise
    from the barrier; the group is destroyed either way.
    """
    if not (dist.is_available() and dist.is_initialized()):
        return
    try:
        if clean:
            if dist.get_backend() == "nccl":
                dist.barrier(device_ids=[torch.cuda.current_device()])
            else:
                dist.barrier()
    finally:
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    """The rank's card index on its host (``LOCAL_RANK``, else the rank)."""
    return int(os.environ.get("LOCAL_RANK", rank())) if is_distributed() else 0


def is_primary() -> bool:
    """True on the rank that writes artifacts and logs (rank 0, or no group)."""
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def process_info() -> dict:
    return {
        "process_index": rank(),
        "process_count": world_size(),
        "local_devices": 1,  # one card (or the CPU) a process
        "global_devices": world_size(),
    }


@contextmanager
def synced_batch(group) -> Iterator[None]:
    """Within the block, batch statistics are summed over ``group`` (None:
    this process's rows alone)."""
    token = _SYNC_GROUP.set(group)
    try:
        yield
    finally:
        _SYNC_GROUP.reset(token)


def sync_group():
    """The group whose ranks share the current batch, or None."""
    return _SYNC_GROUP.get()


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``; autograd's backward sums the gradients
    over the ranks (``torch.distributed.nn.functional.all_reduce``)."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, op=dist.ReduceOp.SUM, group=group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each), stacked in rank order
    along a new leading axis, on every rank: a sum of zero-padded blocks,
    which is exact (each place holds one rank's value) and runs on both
    backends (gloo takes ``all_reduce`` on CUDA tensors, not ``all_gather``).
    What it gathers is small: predictions and probabilities."""
    out = torch.zeros((dist.get_world_size(group), *x.shape), dtype=x.dtype, device=x.device)
    out[dist.get_rank(group)] = x
    dist.all_reduce(out, group=group)
    return out
