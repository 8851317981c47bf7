"""Start a world of ranks in this machine's processes (tests, the dry run,
the chip smoke test): `spawn(fn, world, ...)` runs `fn(rank, world, *args)`
in `world` spawned processes after `torch.distributed.init_process_group`,
and returns their results in rank order. A real deployment launches under
`torchrun --nproc-per-node N`, which initialises the group from its
environment (`init_from_env`).

Each world meets at a `file://` rendezvous (no port to collide with other
worlds started at the same time). Several ranks may share one card under
gloo; NCCL takes one card per rank.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile
import traceback
from datetime import timedelta
from typing import Any, Callable


def _worker(fn, rank: int, world: int, backend: str, device: str | None, init_file: str,
            threads: int, args: tuple, out) -> None:
    import torch
    import torch.distributed as dist

    try:
        torch.set_num_threads(threads)
        if device is not None and device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=timedelta(minutes=10))
        try:
            # plain pickle: the queue's own pickler would share tensors through
            # file descriptors that die with this process
            out.put((rank, True, pickle.dumps(fn(rank, world, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, backend: str = "gloo",
          device_of_rank: Callable[[int], str | None] | None = None,
          init_file: str | None = None, *, args: tuple = (), threads: int = 1,
          timeout: float = 900.0) -> list[Any]:
    """Run `fn(rank, world, *args)` on `world` ranks (each a spawned process
    with `threads` torch threads; `device_of_rank(rank)`, e.g. "cuda:0", is
    made the current card) and return the results in rank order. `fn` and
    its results must pickle (tensors in them on the CPU). `init_file` is the rendezvous file (it must
    not exist yet; default: a fresh one in a temporary directory). Raises
    RuntimeError with the first failed rank's traceback."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="q3a-world-")
        init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_worker, daemon=False, args=(
        fn, r, world, backend, None if device_of_rank is None else device_of_rank(r),
        init_file, threads, args, out)) for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, Any] = {}
    failed: list[str] = []
    try:
        for _ in range(world):
            rank, ok, value = out.get(timeout=timeout)
            if ok:
                results[rank] = pickle.loads(value)
            else:
                failed.append(f"rank {rank}:\n{value}")
                break  # the other ranks may wait on the failed one forever
    finally:
        for p in procs:
            p.join(timeout=5.0 if failed else timeout)
            if p.is_alive():
                p.kill()
                p.join()
        if tmp is not None:
            for name in os.listdir(tmp):
                os.unlink(os.path.join(tmp, name))
            os.rmdir(tmp)
    if failed:
        raise RuntimeError("a rank failed:\n" + failed[0])
    return [results[r] for r in range(world)]


def init_from_env(backend: str) -> None:
    """The default process group of a `torchrun` launch (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT in the environment), once: "nccl" for ranks on
    cards (each rank's card is cuda:LOCAL_RANK), "gloo" on the CPU."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend)
