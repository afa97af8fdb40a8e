"""Run a function on N local ranks without torchrun.

`run_ranks(fn, world, *args)` starts `world` processes (torch.multiprocessing,
spawn), sets RANK, WORLD_SIZE and LOCAL_RANK in each as torchrun does, joins
them into one process group through a `file://` rendezvous in a temporary
directory (no port), calls fn(*args) in each, and returns each rank's
result with the kernel launches that rank counted
(ops/cuda_build.LAUNCHES, which counts only its own process). A rank that
raises, dies or outlasts `timeout` fails the call: the other ranks are
stopped and the error is raised here. fn must be importable by name (a
module-level function) and its result picklable (tensors on the CPU).

Build the CUDA kernels once in the caller (ops/cuda_build.build_all)
before starting ranks on the card, so that they load the libraries rather
than each running nvcc.
"""

from __future__ import annotations

import faulthandler
import os
import tempfile
import time
from typing import Optional

import torch


def _rank_main(rank, world, rdv_dir, backend, device, threads, fn, args):
    faulthandler.enable()  # a rank that crashes prints where
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if threads:
        torch.set_num_threads(threads)
    import torch.distributed as dist

    from ..ops import cuda_build
    from . import mesh as pm

    pm.initialize_distributed(
        backend, init_method="file://" + os.path.join(rdv_dir, "rendezvous"),
        device=device)
    try:
        cuda_build.reset_launches()
        result = fn(*args)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        torch.save({"result": result, "launches": dict(cuda_build.LAUNCHES)},
                   os.path.join(rdv_dir, f"rank{rank}.pt"))
        pm.synchronize()
    finally:
        dist.destroy_process_group()


class Ranks:
    """Ranks started by start_ranks; join() waits for them."""

    def __init__(self, fn, world, args, backend, device, threads, timeout):
        import torch.multiprocessing as mp

        self._dir = tempfile.TemporaryDirectory(prefix="ranks")
        self._name, self._world = fn.__name__, world
        self._deadline = time.monotonic() + timeout
        self._timeout = timeout
        self._ctx = mp.start_processes(
            _rank_main, args=(world, self._dir.name, backend, str(device),
                              threads, fn, args), nprocs=world, join=False,
            start_method="spawn")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.kill()

    def kill(self) -> None:
        """Stop the ranks that still run (after an error, or a join that
        timed out)."""
        for p in self._ctx.processes:
            if p.is_alive():
                p.kill()
        self._dir.cleanup()

    def join(self) -> list:
        """[{"result": fn(*args), "launches": {kernel: count}} of each
        rank], in rank order."""
        try:
            while not self._ctx.join(timeout=1.0):
                if time.monotonic() > self._deadline:
                    raise TimeoutError(f"{self._world} ranks of {self._name}"
                                       f" ran over {self._timeout} s")
            return [torch.load(os.path.join(self._dir.name, f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(self._world)]
        finally:
            self.kill()


def start_ranks(fn, world: int, *args, backend: Optional[str] = None,
                device="cpu", threads: Optional[int] = 1,
                timeout: float = 600.0) -> Ranks:
    """Start fn(*args) on `world` ranks and return at once (the caller
    may work meanwhile); Ranks.join() gives the results. Use it as a
    context manager so that an error in the caller's own work stops the
    ranks. `threads`:
    torch's CPU threads per rank (1 keeps N ranks from oversubscribing the
    cores; None leaves torch's default)."""
    return Ranks(fn, world, args, backend, device, threads, timeout)


def run_ranks(fn, world: int, *args, **kwargs) -> list:
    """start_ranks(...).join()."""
    return start_ranks(fn, world, *args, **kwargs).join()
