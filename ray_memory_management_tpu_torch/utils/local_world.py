"""A ``torch.distributed`` world of spawned processes on this host.

:class:`LocalWorld` starts ``world_size`` processes (the ``spawn``
method: each imports only torch and what the functions it runs need),
joins them into one process group over ``tcp://127.0.0.1`` and keeps
them alive, so that several functions can run on the same world in turn:
``world.run(fn, *args)`` calls ``fn(rank, world_size, *args)`` on every
rank at once and returns the results in rank order. It is how the CPU
tests drive the ``dist`` collectives and the sharded train step over a
gloo world of several ranks.

Functions travel by value (cloudpickle), except those of this package,
which the ranks import.

Every ``run`` has a deadline (``timeout_s``), and so has each rank's
process group (gloo's own timeout). A run that misses it, or a rank that
dies, terminates every rank and breaks the world: each later ``run``
raises at once with the first failure's message, instead of waiting on
ranks stuck in a collective that will never complete.
"""

from __future__ import annotations

import pickle
import sys
import time
import traceback
from typing import Any, Callable, List, Optional

# once one rank has failed, how long the others may take to report before
# the world counts as stuck (they may be waiting on the failed rank)
FAIL_GRACE_S = 10.0
GLOO_SLACK_S = 10.0


def _rank_main(conn, rank: int, world_size: int, init_method: str,
               timeout_s: float) -> None:
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    try:
        # one intra-op thread a rank: the ranks share the host's cores
        torch.set_num_threads(1)
        # gloo's own deadline, a backstop a little past the parent's: the
        # parent's deadline decides, and breaks the world
        dist.init_process_group(
            "gloo", init_method=init_method, world_size=world_size,
            rank=rank, timeout=timedelta(seconds=timeout_s + GLOO_SLACK_S))
        conn.send_bytes(pickle.dumps((True, None)))
    except BaseException:  # noqa: BLE001 — reported to the parent
        conn.send_bytes(pickle.dumps((False, traceback.format_exc())))
        return
    try:
        while True:
            blob = conn.recv_bytes()
            if not blob:
                break
            import cloudpickle

            try:
                fn, args = cloudpickle.loads(blob)
                out = (True, fn(rank, world_size, *args))
                payload = cloudpickle.dumps(out)
            except BaseException:  # noqa: BLE001 — reported to the parent
                payload = cloudpickle.dumps(
                    (False, traceback.format_exc()))
            conn.send_bytes(payload)
    except EOFError:
        pass
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class LocalWorld:
    """``world_size`` live ranks of one process group (see the module
    docstring). Use as a context manager, or call :meth:`close`."""

    def __init__(self, world_size: int, timeout_s: float = 120.0):
        import multiprocessing as mp

        from ..collective.collective import pick_address

        self.world_size = world_size
        self.timeout_s = timeout_s
        self._broken: Optional[str] = None
        ctx = mp.get_context("spawn")
        init_method = f"tcp://{pick_address()}"
        self._conns = []
        self._procs = []
        try:
            for rank in range(world_size):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_rank_main, daemon=True,
                    args=(child, rank, world_size, init_method, timeout_s))
                proc.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(proc)
            self._collect(pickle.loads, "joining the world")
        except BaseException:
            self.close()
            raise

    def _collect(self, loads, what: str) -> List[Any]:
        """Every rank's reply to the last request, in rank order. A rank
        that dies, or a reply missing at the deadline (``timeout_s``, or
        :data:`FAIL_GRACE_S` after another rank failed), breaks the
        world."""
        from multiprocessing.connection import wait

        results: List[Any] = [None] * self.world_size
        errors = []
        pending = {conn: rank for rank, conn in enumerate(self._conns)}
        deadline = time.monotonic() + self.timeout_s
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                ranks = sorted(pending.values())
                self._break(f"ranks {ranks} timed out {what} "
                            f"({self.timeout_s} s)" + "".join(
                                f"\n{e}" for e in errors))
                raise TimeoutError(self._broken)
            for conn in wait(list(pending), timeout=left):
                rank = pending.pop(conn)
                try:
                    ok, value = loads(conn.recv_bytes())
                except (EOFError, OSError):
                    self._break(f"rank {rank} died {what}")
                    raise RuntimeError(self._broken) from None
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    deadline = min(deadline,
                                   time.monotonic() + FAIL_GRACE_S)
        if errors:
            raise RuntimeError(f"{what} failed on "
                               f"{len(errors)} rank(s):\n" +
                               "\n".join(errors))
        return results

    def _break(self, why: str) -> None:
        """Terminate every rank and refuse every later run with ``why``."""
        self._broken = why
        for proc in self._procs:
            if proc.is_alive():
                proc.terminate()
        for proc in self._procs:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []

    def run(self, fn: Callable, *args) -> List[Any]:
        """``fn(rank, world_size, *args)`` on every rank; the results in
        rank order. Raises with each failing rank's traceback, and at
        once on a broken world (see the module docstring)."""
        import cloudpickle

        if self._broken is not None:
            raise RuntimeError(f"the world is broken: {self._broken}")

        module = sys.modules.get(getattr(fn, "__module__", None) or "")
        if module is not None and not module.__name__.startswith(
                __package__.split(".")[0]):
            # by value: the ranks need not import the caller's module
            cloudpickle.register_pickle_by_value(module)
        blob = cloudpickle.dumps((fn, args))
        for conn in self._conns:
            conn.send_bytes(blob)
        return self._collect(cloudpickle.loads,
                             f"{getattr(fn, '__name__', 'fn')}")

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send_bytes(b"")
            except OSError:
                pass
        for proc in self._procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []

    def __enter__(self) -> "LocalWorld":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None
