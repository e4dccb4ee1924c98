"""Local launcher: run a function in one process per rank.

``--dp D --tp T`` (``N = D T`` ranks) without torchrun's environment
starts ``N`` workers on this host with :func:`spawn`
(``torch.multiprocessing`` with the ``spawn`` method, so each worker
starts from a fresh import), as the JAX package's
``--dp N`` runs in one command.  Worker ``r`` joins a process group of
``N`` ranks (NCCL on ``cuda:r % device_count``, gloo on the CPU) through a
file store in a fresh temporary directory, runs ``fn(*args)``, and leaves
the group.  A worker that raises prints its traceback and ends at once,
without leaving the group (the others may be waiting in a collective it
will never join, and a graceful exit would wait with them); the parent
then stops the others and raises here.

Across hosts (``--coordinator host:port --num_processes H --process_id
i``, the JAX package's flags) the same command runs once on every host:
host ``i`` starts its ``N / H`` workers, global ranks ``i N / H`` on, and
all of them meet at a TCP store at the coordinator, which global rank 0
(host 0's first worker) holds.
"""

from __future__ import annotations

import importlib
import os
import shutil
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .distributed import (host_ranks, init_group, maybe_initialize,
                          torchrun_env, world_size)


def _worker(local: int, fn, world: int, device_type: str, init_method: str,
            args: tuple, first: int, per_host: int) -> None:
    rank = first + local
    init_group(device_type, rank, world, init_method, local_rank=local,
               host=rank // per_host)
    try:
        fn(*args)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.barrier()
    dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), device_type: str = "cpu",
          store_dir: str = None, coordinator: str = "", host: int = 0,
          hosts: int = 1) -> None:
    """Run ``fn(*args)`` on ``world`` ranks, one fresh process each, and
    wait for all of them.  ``fn`` must be importable by name (it is
    pickled by reference).  The rendezvous file goes into a new directory
    under ``store_dir`` (default: the temporary directory), removed
    afterwards.  With a ``coordinator`` (``host:port``) this call starts
    only the ``world / hosts`` ranks of host ``host``, and the ranks of
    every host meet at the coordinator's TCP store.  Without one, every
    rank starts here and ``hosts`` declares their grouping: rank ``r`` is
    on host ``r // (world / hosts)`` (what ``--dp_hosts`` then checks, and
    how ``mesh.WIRE_CROSS_HOST`` splits the collective bytes)."""
    per_host = world // hosts
    if coordinator:
        mp.spawn(_worker, args=(fn, world, device_type,
                                "tcp://" + coordinator, args,
                                host * per_host, per_host),
                 nprocs=per_host, join=True)
        return
    root = tempfile.mkdtemp(prefix="sgt_dp_", dir=store_dir)
    try:
        init_method = "file://" + os.path.join(root, "store")
        mp.spawn(_worker, args=(fn, world, device_type, init_method, args,
                                0, per_host), nprocs=world, join=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _cli_worker(module: str, argv: list) -> None:
    importlib.import_module(module).main(argv)


def dispatch(cfg, device: str, module: str, argv: list) -> bool:
    """The multi-process start of a command-line entry point (``module``'s
    ``main(argv)``): with no process group yet, join torchrun's group when
    its environment is set; else with ``--coordinator`` run ``main(argv)``
    on this host's ``cfg.dp * cfg.tp / cfg.num_processes`` workers of the
    multi-host group, or with ``cfg.dp * cfg.tp > 1`` on that many local
    workers, and return True (the caller then returns: the workers did the
    work).  False: the caller runs here, as one rank of the group or
    alone.  ``--model mlp`` always runs here, in one process, whatever
    ``--dp`` and ``--tp`` say (the NeighbourMLP has no multi-device path,
    in either package)."""
    if cfg.model == "mlp":
        return False
    device_type = torch.device(device).type
    world = world_size(cfg)
    if cfg.coordinator and not dist.is_initialized() and not torchrun_env():
        host, hosts, _ = host_ranks(cfg)
        spawn(_cli_worker, world, (module, list(argv)), device_type,
              coordinator=cfg.coordinator, host=host, hosts=hosts)
        return True
    if world > 1 and not dist.is_initialized() and not torchrun_env():
        spawn(_cli_worker, world, (module, list(argv)), device_type)
        return True
    maybe_initialize(cfg, device_type)
    return False
