"""Start D local ranks, one process a device, and wait for them.

:func:`spawn` runs ``fn(rank, world, *args)`` in ``world`` processes made
with the ``spawn`` start method (``torch.multiprocessing``), each with an
initialized process group: NCCL with ``cuda:<rank>`` on ``device="cuda"``
(it raises if there are fewer cards than ranks), gloo on ``device="cpu"``.
The ranks meet through a ``file://`` store in a temporary directory, never
a fixed TCP port, so several runs on one machine cannot collide.

A child imports the module that defines ``fn`` anew, so ``fn`` is a
module-level function of a module that imports no more than it needs (the
port's workers import torch, never jax).  Each rank's return value comes
back pickled through the temporary directory, which only these processes
write.  A rank that has imported jax by the time ``fn`` returns fails.
The parent waits at most ``timeout`` seconds: a rank that raises
ends the run at once with its traceback, a rank that hangs ends it at the
timeout; either way every rank is stopped and :func:`spawn` raises.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, device: str, tmp: str, threads: int, fn, args) -> None:
    """A rank's process: the process group, ``fn``, its result to ``tmp``;
    on an exception its traceback to ``tmp`` and exit code 1."""
    try:
        torch.set_num_threads(threads)
        if device == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=600),
        )
        try:
            out = fn(rank, world, *args)
            # No rank leaves the group before every rank is done with it: a
            # rank that tore its side down at once could close a connection
            # that a slower peer was still making in init_process_group
            # (gloo: "connectFullMesh failed ... Connection closed by peer").
            dist.barrier()
        finally:
            dist.destroy_process_group()
        if "jax" in sys.modules:
            raise RuntimeError("a rank imported jax: the port and its workers import torch, never jax")
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn(fn, world: int, *args, device: str, timeout: float | None = 300.0, threads: int = 1) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` local ranks and return
    their results, rank by rank.  ``device`` (``"cuda"`` or ``"cpu"``) has
    no default: the caller names the ranks' devices.  ``timeout=None`` waits as long as the
    ranks run; ``threads`` caps each rank's torch threads (many ranks share
    the host's cores)."""
    if world < 1:
        raise ValueError(f"world size must be >= 1, got {world}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards, {torch.cuda.device_count()} visible: NCCL takes one a rank")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="nbody_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, world, device, tmp, threads, fn, args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            _join(procs, tmp, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _join(procs, tmp: str, timeout: float | None) -> None:
    """Wait for every rank; raise at the first failure or at the timeout.
    After a failure the others get a few seconds to fail too (a rank that
    raises takes its peers' collectives down with it, and one of those may
    exit first), and every traceback written by then is reported."""
    deadline = time.monotonic() + (float("inf") if timeout is None else timeout)
    while True:
        codes = [p.exitcode for p in procs]
        if any(c not in (None, 0) for c in codes):
            grace = time.monotonic() + 5.0
            while any(p.exitcode is None for p in procs) and time.monotonic() < grace:
                time.sleep(0.05)
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            raise RuntimeError(f"rank(s) {failed} failed (exit codes {[codes[r] for r in failed]}):\n"
                               + "\n".join(_errors(tmp, range(len(procs)))))
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            waiting = [r for r, c in enumerate(codes) if c is None]
            raise TimeoutError(f"rank(s) {waiting} still running after {timeout:g} s; all ranks stopped")
        time.sleep(0.05)


def _errors(tmp: str, ranks) -> list[str]:
    """The tracebacks the given ranks wrote."""
    out = []
    for r in ranks:
        path = os.path.join(tmp, f"error_{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                out.append(f"--- rank {r} ---\n{f.read()}")
    return out
