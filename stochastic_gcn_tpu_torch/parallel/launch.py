"""Local launcher: run a function in one process per rank.

``--dp N`` without torchrun's environment starts ``N`` workers on this
host with :func:`spawn` (``torch.multiprocessing`` with the ``spawn``
method, so each worker starts from a fresh import), as the JAX package's
``--dp N`` runs in one command.  Worker ``r`` joins a process group of
``N`` ranks (NCCL on ``cuda:r % device_count``, gloo on the CPU) through a
file store in a fresh temporary directory, runs ``fn(*args)``, and leaves
the group.  A worker that raises prints its traceback and ends at once,
without leaving the group (the others may be waiting in a collective it
will never join, and a graceful exit would wait with them); the parent
then stops the others and raises here.
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

from .distributed import init_group, maybe_initialize, torchrun_env


def _worker(rank: int, fn, world: int, device_type: str, init_method: str,
            args: tuple) -> None:
    init_group(device_type, rank, world, init_method)
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
          store_dir: str = None) -> None:
    """Run ``fn(*args)`` on ``world`` ranks, one fresh process each, and
    wait for all of them.  ``fn`` must be importable by name (it is
    pickled by reference).  The rendezvous file goes into a new directory
    under ``store_dir`` (default: the temporary directory), removed
    afterwards."""
    root = tempfile.mkdtemp(prefix="sgt_dp_", dir=store_dir)
    try:
        init_method = "file://" + os.path.join(root, "store")
        mp.spawn(_worker, args=(fn, world, device_type, init_method, args),
                 nprocs=world, join=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _cli_worker(module: str, argv: list) -> None:
    importlib.import_module(module).main(argv)


def dispatch(cfg, device: str, module: str, argv: list) -> bool:
    """The data-parallel start of a command-line entry point (``module``'s
    ``main(argv)``): with ``cfg.dp > 1`` and no process group yet, join
    torchrun's group when its environment is set, or else run ``main(argv)``
    on ``cfg.dp`` local workers and return True (the caller then returns:
    the workers did the work).  False: the caller runs here, as one rank
    of the group or alone."""
    device_type = torch.device(device).type
    if cfg.dp > 1 and not dist.is_initialized() and not torchrun_env():
        spawn(_cli_worker, cfg.dp, (module, list(argv)), device_type)
        return True
    maybe_initialize(cfg, device_type)
    return False
