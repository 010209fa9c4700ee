"""Start the ranks of a mesh on one host: :func:`run_ranks`.

Each rank is a process started with the ``spawn`` method (CUDA cannot
fork), in a process group the launcher initializes at
``tcp://localhost:<free port>`` with the caller's backend: ``nccl`` with
one card per rank (``devices``, set before the group is made), ``gloo``
on the CPU (the tests) or on CUDA tensors of ranks that share a card.
``fn(rank, *args)`` runs in every rank; what it returns (picklable) comes
back in rank order.  A rank that raises, or dies, fails the whole run:
the launcher stops every process it started and raises with the rank's
traceback.  Nothing falls back to another backend or device.

Outside the tests the same library runs under ``torchrun`` (one process
per card, ``LOCAL_RANK`` set): the caller calls
``torch.distributed.init_process_group("nccl")`` and builds its
``Pastix`` with ``mesh_shape``.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, nranks, backend, devices, port, threads, out, args):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(nranks),
                      LOCAL_RANK=str(rank))
    try:
        if threads:
            torch.set_num_threads(threads)
        if devices is not None:
            torch.cuda.set_device(devices[rank])
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=nranks)
        try:
            res = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:  # every failure goes back to the launcher
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, nranks: int, backend: str = "gloo", devices=None,
              args=(), threads: int = 0, timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``nranks`` spawned processes that form
    one process group of ``backend``; returns their results in rank
    order.  ``devices``: the CUDA device of each rank (NCCL needs one
    card a rank; ranks sharing a card run gloo).  ``threads``: each
    rank's ``torch.set_num_threads`` (0 leaves it).  ``fn`` must be
    importable by name (a module-level function).  Raises
    ``RuntimeError`` when a rank fails, dies or outlives ``timeout``
    seconds; every process is stopped before this returns or raises."""
    if devices is not None and len(devices) != nranks:
        raise ValueError(f"{nranks} ranks but {len(devices)} devices")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nranks, backend, devices, port,
                               threads, out, tuple(args)))
             for r in range(nranks)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    t_end = time.monotonic() + timeout
    t_grace = None  # after a failure, the others' last moment to report
    try:
        while len(results) + len(errors) < nranks:
            now = time.monotonic()
            if t_grace is not None and now > t_grace:
                break
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                # a rank that died without a word: the others may block
                # on it in a collective forever
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0) and r not in results:
                        errors.setdefault(r, f"died (exit code {p.exitcode})")
                if errors and t_grace is None:
                    t_grace = now + 5.0
                if now > t_end and t_grace is None:
                    errors[-1] = f"no result within {timeout:.0f} s"
                    break
                continue
            if ok:
                results[rank] = res
            else:
                errors[rank] = res
                if t_grace is None:  # collect the others' reports too
                    t_grace = time.monotonic() + 5.0
        if errors:
            raise RuntimeError(
                f"run_ranks: {len(errors)} of {nranks} ranks failed:\n"
                + "\n".join(f"rank {r}: {e}" if r >= 0 else e
                            for r, e in sorted(errors.items())))
        return [results[r] for r in range(nranks)]
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
