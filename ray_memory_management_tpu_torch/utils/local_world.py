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
"""

from __future__ import annotations

import pickle
import sys
import traceback
from typing import Any, Callable, List, Optional


def _rank_main(conn, rank: int, world_size: int, init_method: str) -> None:
    import torch
    import torch.distributed as dist

    try:
        # one intra-op thread a rank: the ranks share the host's cores
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world_size, rank=rank)
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
        ctx = mp.get_context("spawn")
        init_method = f"tcp://{pick_address()}"
        self._conns = []
        self._procs = []
        try:
            for rank in range(world_size):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_rank_main, daemon=True,
                    args=(child, rank, world_size, init_method))
                proc.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(proc)
            self._collect(pickle.loads, "joining the world")
        except BaseException:
            self.close()
            raise

    def _collect(self, loads, what: str) -> List[Any]:
        results, errors = [], []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(self.timeout_s):
                raise TimeoutError(f"rank {rank} timed out {what} "
                                   f"({self.timeout_s} s)")
            ok, value = loads(conn.recv_bytes())
            if ok:
                results.append(value)
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"{what} failed on "
                               f"{len(errors)} rank(s):\n" +
                               "\n".join(errors))
        return results

    def run(self, fn: Callable, *args) -> List[Any]:
        """``fn(rank, world_size, *args)`` on every rank; the results in
        rank order. Raises with each failing rank's traceback."""
        import cloudpickle

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
