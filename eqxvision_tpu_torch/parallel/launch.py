"""A world of local processes for a function, on ``torch.multiprocessing.spawn``.

    results = run(function, 4, args=(...), device="cpu", timeout_s=300)  # one result a rank, in rank order

or ``world = World(function, 4, ...)``, other work, then ``world.wait()``.
``function`` is a module-level function (spawn pickles it by name).

``placement`` chooses each rank's device and the backend: the CPU over
gloo; on the cards one card a rank over NCCL where there are as many cards
as ranks, else the ranks round-robin on the cards over gloo (NCCL refuses
two ranks on one card; gloo all-reduces and broadcasts CUDA tensors, which
is all the training path needs). Each rank sets its card current, joins
the world through a ``FileStore`` in the world's temporary directory (no
port to choose and release), gets torchrun's ``RANK``, ``LOCAL_RANK`` and
``WORLD_SIZE`` in its environment and the host's cores over ``n`` as its
threads (unless ``OMP_NUM_THREADS`` is set), calls ``function(*args)``
and saves what it returns (tensors, numbers, strings, and lists, tuples
and dicts of them) for the parent. ``rank_device()`` is the device the
rank was placed on. A rank that raises stops the world, and ``wait`` raises
with its traceback; so it does, naming the ranks still running, when the
time is up. No rank outlives ``wait``.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_DEVICE = torch.device("cpu")  # this rank's device, set in each rank


def placement(n: int, device: str = "cuda") -> Tuple[str, List[torch.device]]:
    """The backend and each of ``n`` ranks' devices on ``device`` ("cpu" or "cuda")."""
    if device == "cpu":
        return "gloo", [torch.device("cpu")] * n
    if device != "cuda":
        raise ValueError(f"device is 'cpu' or 'cuda', not {device!r}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA card: pass device='cpu' to run the world on the CPU")
    if cards >= n:
        return "nccl", [torch.device("cuda", r) for r in range(n)]
    return "gloo", [torch.device("cuda", r % cards) for r in range(n)]


def rank_device() -> torch.device:
    """The device ``placement`` gave this rank (the CPU outside a world)."""
    return _DEVICE


def _rank(index: int, fn: Callable, args: Sequence[Any], n: int, backend: str, devices: List[torch.device],
          out_dir: str) -> None:
    global _DEVICE
    out = Path(out_dir)
    try:
        os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n))
        if "OMP_NUM_THREADS" not in os.environ:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))  # the ranks share the host's cores
        _DEVICE = devices[index]
        if _DEVICE.type == "cuda":
            torch.cuda.set_device(_DEVICE)
        dist.init_process_group(backend, init_method=f"file://{out / 'store'}", rank=index, world_size=n)
        result = fn(*args)
        torch.save(result, out / f"result{index}.pt.tmp")
        os.replace(out / f"result{index}.pt.tmp", out / f"result{index}.pt")
        dist.destroy_process_group()
    except BaseException:
        (out / f"error{index}.txt").write_text(traceback.format_exc())
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)  # without waiting on the process group's threads; the parent stops the other ranks


class World:
    """``n`` local processes running ``fn(*args)``, placed by ``placement``."""

    def __init__(self, fn: Callable, n: int, args: Sequence[Any] = (), *, device: str = "cuda",
                 timeout_s: float = 600.0):
        self.n, self.timeout_s = n, timeout_s
        self.backend, self.devices = placement(n, device)
        self._tmp = tempfile.TemporaryDirectory(prefix="eqx_world_")
        self.dir = Path(self._tmp.name)
        self.started = time.perf_counter()
        self._context = mp.start_processes(_rank, (fn, tuple(args), n, self.backend, self.devices, str(self.dir)),
                                           nprocs=n, join=False, start_method="spawn")

    def _error(self, index: int) -> str:
        path = self.dir / f"error{index}.txt"
        return path.read_text() if path.exists() else ""

    def wait(self) -> List[Any]:
        """Every rank's result, in rank order."""
        try:
            try:
                while not self._context.join(max(0.0, self.started + self.timeout_s - time.perf_counter())):
                    if time.perf_counter() - self.started >= self.timeout_s:
                        running = [r for r, p in enumerate(self._context.processes) if p.is_alive()]
                        raise TimeoutError(f"ranks {running} of {self.n} still running after {self.timeout_s:.0f} s")
            except mp.ProcessExitedException as e:
                raise RuntimeError(f"rank {e.error_index} of {self.n} failed ({e}):\n{self._error(e.error_index)}"
                                   ) from None
            return [torch.load(self.dir / f"result{r}.pt", weights_only=True) for r in range(self.n)]
        finally:
            for p in self._context.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            self._tmp.cleanup()


def run(fn: Callable, n: int, args: Sequence[Any] = (), **kwargs) -> List[Any]:
    """Start a ``World`` and wait for it."""
    return World(fn, n, args, **kwargs).wait()
