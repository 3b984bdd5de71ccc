"""A worker process per device: ``ShardPool``.

A sharded experiment grid (``fl/engine.py``) sweeps each shard on its own
card.  Host threads of one process contend for the interpreter lock at
every op, so the cards' launches are issued at the same time only from
separate interpreters: one spawned worker process a device (CUDA cannot be
forked).  The pool is generic: a picklable top-level function, with its
arguments, runs on every rank with the rank's device current.

    pool = ShardPool(("cuda:0", "cuda:1"), init=build_state, init_args=(spec,))
    outs = pool.run(sweep, [(shard0,), (shard1,)])   # one result a rank
    pool.close()

A worker's start-up, in order: ``torch.cuda.set_device`` (before any other
CUDA call, so that no worker opens a context on another card), then
``torch.set_num_threads`` with the caller's count (the CPU's reductions
depend on it), then ``init(worker, *init_args)``, whose result the worker
keeps as ``worker.state`` for the pool's life.  Each call then runs
``fn(worker, *args)``, the caller's thread count applied first.

Every message is ``pickle.dumps`` of a tuple, sent with ``send_bytes``: by
value, so a CPU tensor arrives as an exact copy and nothing goes through
shared memory.  A call pickles every rank's arguments before it sends any.

No fallback: a worker that raises makes ``run`` raise ``WorkerError`` with
the worker's traceback, and one that dies (a kill, a segfault, out of
memory) is found by polling its liveness every ``POLL_S``; either way the
pool is closed.  ``close()``, ``with ShardPool(...)`` and a
``weakref.finalize`` at exit end the workers: each is asked to stop, and
terminated if it has not left within its grace.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
import traceback
import weakref
from multiprocessing import connection
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

POLL_S = 0.1  # how often a waiting caller checks that its workers are alive
STOP_S = 5.0  # how long ``close()`` lets a worker leave before it terminates it


class WorkerError(RuntimeError):
    """A worker raised, died or did not start; its pool is closed."""


@dataclasses.dataclass
class Worker:
    """What a function run on a worker receives first: its rank, its device,
    the pool's size and ``state``, what the pool's ``init`` returned."""

    rank: int
    device: torch.device
    world: int
    state: Any = None


def _send(conn, msg) -> None:
    conn.send_bytes(pickle.dumps(msg))


def _serve(rank: int, device: str, world: int, threads: int, conn, init, init_args) -> None:
    """A worker's life: start up, then run each call until told to stop."""
    me = Worker(rank, torch.device(device), world)
    try:
        if me.device.type == "cuda":
            torch.cuda.set_device(me.device)
        torch.set_num_threads(threads)
        if init is not None:
            me.state = init(me, *init_args)
        _send(conn, ("ok", os.getpid()))
    except Exception:  # sent to the caller, which raises it
        _send(conn, ("error", traceback.format_exc()))
        return
    while True:
        try:
            msg = conn.recv_bytes()
        except EOFError:  # the caller is gone
            return
        try:
            call = pickle.loads(msg)
            if call[0] == "stop":
                return
            _, fn, args, threads = call
            if torch.get_num_threads() != threads:
                torch.set_num_threads(threads)
            out = pickle.dumps(("ok", fn(me, *args)))
        except Exception:  # sent to the caller, which raises it
            out = pickle.dumps(("error", traceback.format_exc()))
        conn.send_bytes(out)


def _stop(procs, conns, grace: float) -> None:
    """Ask every worker to stop, give them ``grace`` seconds together, then
    terminate (and at last kill) those still alive."""
    for p, conn in zip(procs, conns):
        if p.is_alive():
            try:
                _send(conn, ("stop",))
            except (OSError, ValueError):
                pass
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(1.0)
        if p.is_alive():
            p.kill()
            p.join()
    for conn in conns:
        conn.close()


class ShardPool:
    """One persistent spawned worker a device, in the given order (rank r
    on ``devices[r]``); started in the constructor, which returns once
    every worker has run ``init``.  ``start_s``: the start-up's seconds;
    ``pids``: the workers' process ids."""

    def __init__(self, devices: Sequence, init: Optional[Callable] = None,
                 init_args: tuple = ()):
        self.devices = tuple(torch.device(d) for d in devices)
        ctx = mp.get_context("spawn")
        self._procs: list = []
        self._conns: list = []
        self._finalizer = weakref.finalize(self, _stop, self._procs, self._conns, STOP_S)
        t0 = time.perf_counter()
        threads = torch.get_num_threads()
        for rank, dev in enumerate(self.devices):
            here, there = ctx.Pipe()
            proc = ctx.Process(target=_serve, name=f"shard-{rank}", daemon=True,
                               args=(rank, str(dev), len(self.devices), threads, there, init,
                                     tuple(init_args)))
            proc.start()
            there.close()
            self._procs.append(proc)
            self._conns.append(here)
        self.pids: List[int] = self._gather("start-up")
        self.start_s = time.perf_counter() - t0

    @property
    def alive(self) -> bool:
        """True until the pool is closed."""
        return self._finalizer.alive

    def run(self, fn: Callable, args: Sequence[tuple]) -> list:
        """``fn(worker, *args[r])`` on every rank r at once; the results in
        rank order.  Raises ``WorkerError`` (and closes the pool) when a
        worker raises or dies; raises whatever pickling raises, before
        anything is sent, when an argument does not pickle."""
        if not self.alive:
            raise WorkerError("the shard pool is closed")
        if len(args) != len(self.devices):
            raise ValueError(f"ShardPool.run: {len(args)} argument tuples for "
                             f"{len(self.devices)} workers")
        threads = torch.get_num_threads()
        msgs = [pickle.dumps(("call", fn, tuple(a), threads)) for a in args]
        for conn, msg in zip(self._conns, msgs):
            conn.send_bytes(msg)
        return self._gather(getattr(fn, "__qualname__", repr(fn)))

    def _gather(self, what: str) -> list:
        """Every worker's answer, in rank order, polling their liveness."""
        out: list = [None] * len(self.devices)
        pending = set(range(len(self.devices)))
        while pending:
            connection.wait([self._conns[r] for r in pending]
                            + [self._procs[r].sentinel for r in pending], timeout=POLL_S)
            for r in sorted(pending):
                conn, proc = self._conns[r], self._procs[r]
                status = None
                if conn.poll():
                    try:
                        status, payload = pickle.loads(conn.recv_bytes())
                    except EOFError:  # its end closed: it is leaving
                        proc.join(1.0)
                        status = "died"
                if status == "ok":
                    out[r] = payload
                    pending.discard(r)
                elif status == "error":
                    self._fail(f"worker {r} on {self.devices[r]} (pid {proc.pid}) raised "
                               f"in {what}:\n{payload}")
                elif status == "died" or not proc.is_alive():
                    self._fail(f"worker {r} on {self.devices[r]} (pid {proc.pid}) died in "
                               f"{what} with exit code {proc.exitcode}")
        return out

    def _fail(self, message: str) -> None:
        _stop(self._procs, self._conns, 0.2)
        self._finalizer.detach()
        raise WorkerError(message)

    def close(self) -> None:
        """End every worker (idempotent)."""
        self._finalizer()

    def __enter__(self) -> "ShardPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
