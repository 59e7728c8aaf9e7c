"""Start ranks on this host and collect what they return.

``run_ranks(job, world, backend, device, args, timeout_s)`` spawns
``world`` processes (the ``spawn`` start method: a rank imports only what
the job's module imports, never the parent's test modules or jax), joins
them in one process group over ``tcp://127.0.0.1:<free port>``, and calls
``job(mesh, *args)`` in each with its ``parallel.mesh.Mesh``. It returns
the ranks' results in rank order; a result crosses back by pickling, so
jobs return numpy arrays and plain values.

No run hangs without an end: the process group has a timeout, and the
parent kills every rank and raises, with the failing rank's traceback, as
soon as one rank raises or dies, or when ``timeout_s`` runs out. Nothing
is caught and carried on.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

# How long the parent waits, after the last result, for a rank to exit.
_JOIN_S = 30.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(job, rank: int, world: int, backend: str, device, port: int, args: tuple,
               timeout_s: float, threads: Optional[int], results) -> None:
    import torch
    import torch.distributed as dist

    from cuadmm_tpu_torch.parallel.mesh import make_mesh

    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        mesh = make_mesh(world, backend, device)
        out = job(mesh, *args)
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which kills every rank and raises
        results.put((rank, False, traceback.format_exc()))
        return
    dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(5)


def run_ranks(
    job: Callable[..., Any],
    world: int,
    backend: Optional[str] = None,
    device="cuda",
    args: Sequence[Any] = (),
    timeout_s: float = 300.0,
    threads: Optional[int] = 1,
) -> List[Any]:
    """``job(mesh, *args)`` on ``world`` spawned ranks; their results in rank order.

    ``job`` must be importable by name (a module-level function of a
    module that imports no test file). ``device`` is every rank's device:
    "cuda" (rank r on cuda:(r % device_count)), one card for all
    ("cuda:0", which needs backend "gloo": NCCL refuses two ranks on one
    GPU) or "cpu". ``backend`` None: "nccl" on CUDA, "gloo" on the CPU.
    ``threads`` sets torch's CPU threads in each
    rank (None: torch's default). Raises RuntimeError with the traceback of
    the first rank that fails or dies, and TimeoutError when the results
    are not all in after ``timeout_s`` seconds; either way every rank is
    killed first.
    """
    backend = backend or ("gloo" if str(device) == "cpu" else "nccl")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(job, r, world, backend, device, port, tuple(args), timeout_s, threads, results),
            name=f"rank{r}",
            daemon=True,
        )
        for r in range(world)
    ]
    for p in procs:
        p.start()
    out: List[Any] = [None] * world
    pending = set(range(world))
    deadline = time.monotonic() + timeout_s
    try:
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: ranks {sorted(pending)} of {world} gave no result within {timeout_s:g} s"
                )
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r in pending if not procs[r].is_alive()]
                if dead:
                    # A rank that died without reporting (killed, or a hard
                    # crash); give its queued report, if any, a moment.
                    try:
                        rank, ok, payload = results.get(timeout=1.0)
                    except queue.Empty:
                        r = dead[0]
                        raise RuntimeError(
                            f"run_ranks: rank {r} of {world} exited with code {procs[r].exitcode} "
                            "and no result"
                        ) from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} of {world} failed:\n{payload}")
            out[rank] = payload
            pending.discard(rank)
        for p in procs:
            p.join(_JOIN_S)
    finally:
        _stop(procs)
        results.close()
    return out

