"""Start the ranks of a process group from one Python process.

``spawn(fn, nprocs, *args)`` starts ``nprocs`` processes (the 'spawn'
start method), each joins a group at ``tcp://localhost:<free port>``
(``mesh.initialize_distributed``) and runs ``fn(rank, *args)``; the parent
gets the ranks' return values in rank order. A rank that raises, or dies,
makes ``spawn`` raise with its traceback, after the other ranks are given a
moment and then stopped: no rank outlives the call. ``torchrun`` is the
other way to start the same functions (``initialize_distributed`` with no
address reads its environment).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import socket
import traceback
from typing import Any, Callable, List, Optional


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, nprocs, port, backend, device, args, out):
    import torch.distributed as dist

    from ampnet_tpu_torch.parallel.mesh import initialize_distributed

    try:
        os.environ["LOCAL_RANK"] = str(rank)
        initialize_distributed(f"localhost:{port}", nprocs, rank, backend=backend,
                               device=device)
        result = fn(rank, *args)
        # plain pickle: tensors travel by value, not through shared memory
        # that the rank frees when it exits
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:  # noqa: BLE001 - the parent reports it
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable[..., Any], nprocs: int, *args, backend: Optional[str] = None,
          device="cuda", timeout: float = 1800.0, grace: float = 20.0) -> List[Any]:
    """``fn(rank, *args)`` on ``nprocs`` ranks of one process group (gloo
    or NCCL: ``mesh.default_backend`` for ``device`` unless ``backend``);
    returns their results by rank. ``fn`` and its arguments and results
    must pickle (``fn`` a module-level function)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nprocs, port, backend, device, args, out), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    waited, failed_at = 0.0, None
    try:
        while len(results) + len(errors) < nprocs:
            try:
                rank, ok, value = out.get(timeout=1.0)
                (results if ok else errors)[rank] = value
                if not ok and failed_at is None:
                    failed_at = waited
                continue
            except queue.Empty:
                waited += 1.0
            dead = [r for r, p in enumerate(procs)
                    if not p.is_alive() and p.exitcode not in (0, None)
                    and r not in results and r not in errors]
            for r in dead:
                errors[r] = f"rank {r} exited with code {procs[r].exitcode}"
                if failed_at is None:
                    failed_at = waited
            if failed_at is not None and waited - failed_at > grace:
                break
            if waited > timeout:
                errors[-1] = f"timed out after {timeout:.0f} s"
                break
    finally:
        for p in procs:
            p.join(timeout=grace if not errors else 1.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
    if errors or len(results) < nprocs:
        lost = [r for r in range(nprocs) if r not in results and r not in errors]
        detail = "\n".join(f"--- rank {r}:\n{e}" for r, e in sorted(errors.items()))
        raise RuntimeError(f"{len(errors) or len(lost)} of {nprocs} ranks failed "
                           f"(no result from {lost}):\n{detail}")
    return [pickle.loads(results[r]) for r in range(nprocs)]
