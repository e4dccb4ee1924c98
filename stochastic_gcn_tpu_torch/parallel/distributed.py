"""Process-group bootstrap for data-parallel (``--dp > 1``) runs.

Port of stochastic_gcn_tpu/parallel/distributed.py.  One process drives
one device: NCCL on CUDA devices, gloo on the CPU.  A group comes from one
of three places:

* torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and its
  ``MASTER_ADDR`` / ``MASTER_PORT`` store): :func:`maybe_initialize` joins
  it, so ``torchrun --nproc_per_node 4 -m stochastic_gcn_tpu_torch.cli.train
  --dp 4 ...`` runs as it would under JAX's multi-controller launch (and
  ``--nnodes H`` across hosts: a rank's host is torchrun's ``GROUP_RANK``);
* a local spawn (:mod:`.launch`), which hands every worker its rank, the
  world size and a rendezvous address and calls :func:`init_group`;
* the multi-host launch, JAX's flags ``--coordinator host:port
  --num_processes H --process_id i`` (:func:`host_ranks`): a "process"
  there is a host, since the port runs one process per device.  Host ``i``
  spawns ``dp tp / H`` local ranks (:mod:`.launch`), global rank ``i (dp
  tp / H) + local``, so the ranks are host-major by construction, and
  every rank joins one group through a TCP store at the coordinator, held
  by host 0's local rank 0 (global rank 0).

A group has ``dp * tp`` ranks (``--tp``, tensor parallelism: the model
axis is innermost, parallel/mesh.py), one per device.

Every rank loads the same data and draws from the same seeded generators,
so the ranks run one global schedule in step (training/step.py).
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

# How long a collective may wait for the other ranks before the group
# raises: well past the longest wait of one rank for another (a Trainer's
# set-up, a one-process reference run on rank 0), short enough that a
# rank that died leaves the others failing rather than hanging.
TIMEOUT = timedelta(seconds=300)

# this process's host in a multi-host launch (set by init_group; torchrun's
# GROUP_RANK otherwise, 0 on one host)
_HOST = None


def world_size(cfg) -> int:
    """The ranks a run of ``cfg`` takes: ``dp * tp``."""
    return cfg.dp * cfg.tp


def host_ranks(cfg) -> tuple:
    """``(host, hosts, local ranks)`` of a ``--coordinator`` launch: host
    ``cfg.process_id`` of ``cfg.num_processes``, each starting ``cfg.dp *
    cfg.tp / hosts`` ranks (whole model groups).  A mismatch raises:
    ``dp`` not a multiple of the hosts, a ``process_id`` out of range, or
    ``--dp_hosts`` set to another host count."""
    hosts = cfg.num_processes
    if hosts < 1 or cfg.dp % hosts:
        raise ValueError(f"--dp {cfg.dp} does not tile over "
                         f"--num_processes {hosts} hosts")
    if not 0 <= cfg.process_id < hosts:
        raise ValueError(f"--process_id {cfg.process_id} is not a host of "
                         f"--num_processes {hosts}")
    if cfg.dp_hosts not in (1, hosts):
        raise ValueError(f"--dp_hosts {cfg.dp_hosts} but --num_processes "
                         f"{hosts} hosts")
    return cfg.process_id, hosts, world_size(cfg) // hosts


def host_index() -> int:
    """This process's host: the one its launcher gave it, or torchrun's
    ``GROUP_RANK``, or 0."""
    if _HOST is not None:
        return _HOST
    return int(os.environ.get("GROUP_RANK", "0"))


def init_group(device_type: str, rank: int, world: int,
               init_method: str = "env://", local_rank: int = -1,
               host: int = None) -> None:
    """Join the process group of ``world`` ranks as ``rank`` and, on CUDA,
    make ``cuda:local_rank`` (default ``rank % device_count``) this
    process's device.  ``host``: this rank's host in a multi-host launch
    (:func:`host_index`).  CPU workers run one thread each: several ranks
    share the host's cores."""
    global _HOST
    if host is not None:
        _HOST = host
    kw = {}
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group needs CUDA")
        local = rank if local_rank < 0 else local_rank
        kw["device_id"] = torch.device("cuda",
                                       local % torch.cuda.device_count())
        torch.cuda.set_device(kw["device_id"])
    else:
        torch.set_num_threads(1)
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            rank=rank, world_size=world, timeout=TIMEOUT,
                            **kw)


def torchrun_env() -> bool:
    """True when torchrun (or any launcher setting its variables) started
    this process."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def maybe_initialize(cfg, device_type: str) -> int:
    """Join torchrun's group when its environment is set and no group
    exists yet; returns this process's rank (0 without a group).  The
    group's size must be ``cfg.dp * cfg.tp``: a mismatch raises rather
    than running another width than the one asked for (in a multi-host
    launch too: every host's ranks join the one group)."""
    if not dist.is_initialized() and torchrun_env():
        init_group(device_type, int(os.environ["RANK"]),
                   int(os.environ["WORLD_SIZE"]),
                   local_rank=int(os.environ.get("LOCAL_RANK", "-1")))
    if dist.is_initialized() and dist.get_world_size() != world_size(cfg):
        raise ValueError(f"--dp {cfg.dp} --tp {cfg.tp} but the process "
                         f"group has {dist.get_world_size()} ranks")
    return rank()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def quiet(*_args, **_kw) -> None:
    """The log of a rank other than 0: nothing."""


def main_log(log=print):
    """``log`` on rank 0 (or without a group), :func:`quiet` elsewhere."""
    return log if is_main() else quiet


def allreduce_flag(flag: bool, device=None) -> bool:
    """Max-reduce a host-side flag over the ranks so every rank takes the
    same branch at a synchronisation point (the preemption stop at an
    epoch boundary: a split decision would leave one rank in the final
    save's gathers and another in the next epoch's gradient all-reduce).
    Without a group, the flag unchanged."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
