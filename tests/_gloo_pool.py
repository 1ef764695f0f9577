"""A pool of gloo ranks for the port's mesh tests.

``GlooPool(world)`` spawns ``world`` processes (``torch.multiprocessing``,
spawn) that join one gloo world and then run tasks until closed:
``pool.run(fn, *args)`` sends ``fn`` (a module-level function, pickled by
reference, so its module must not import JAX) to every rank and returns
each rank's result in rank order.  Each rank imports torch once for the
whole module; a task past ``timeout`` seconds, or a rank that dies, kills
the pool and fails the call (the next ``run`` on a broken pool raises).
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback

import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, addr: str, tasks, results):
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # one host
    try:
        dist.init_process_group("gloo", init_method=addr, world_size=world,
                                rank=rank,
                                timeout=datetime.timedelta(seconds=90))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, "up"))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            results.put((rank, True, fn(*args, **kwargs)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


# starts of the world on a fresh port when rank 0 could not listen on the
# one _free_port() found (released, so another process can take it first)
START_ATTEMPTS = 3


class GlooPool:
    def __init__(self, world: int, start_timeout: float = 120.0):
        ctx = mp.get_context("spawn")
        self.world = world
        for attempt in range(START_ATTEMPTS):
            self.results = ctx.Queue()
            self.tasks = [ctx.Queue() for _ in range(world)]
            addr = f"tcp://127.0.0.1:{_free_port()}"
            self.procs = [ctx.Process(target=_rank_main,
                                      args=(r, world, addr, self.tasks[r],
                                            self.results), daemon=True)
                          for r in range(world)]
            for p in self.procs:
                p.start()
            self.broken = None
            try:
                self._collect(start_timeout, "start")
                return
            except RuntimeError as e:
                if "EADDRINUSE" not in str(e) \
                        or attempt + 1 == START_ATTEMPTS:
                    raise

    def _collect(self, timeout: float, what: str):
        out, errs = {}, {}
        deadline = time.monotonic() + timeout
        while len(out) + len(errs) < self.world:
            try:
                rank, ok, val = self.results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close()
                    self.broken = (f"{what}: ranks {dead} died" if dead else
                                   f"{what}: over {timeout:.0f} s; killed")
                    raise RuntimeError(self.broken + f"; errors {errs}")
                continue
            (out if ok else errs)[rank] = val
        if errs:
            # a rank that raised leaves its peers in a collective: the
            # pool cannot be trusted after it
            self.close()
            self.broken = f"{what}: a rank raised"
            raise RuntimeError(f"{what}: ranks raised:\n" + "\n".join(
                f"--- rank {r}\n{e}" for r, e in sorted(errs.items())))
        return [out[r] for r in range(self.world)]

    def run(self, fn, *args, timeout: float = 120.0, **kwargs):
        if self.broken:
            raise RuntimeError(f"the gloo pool is broken ({self.broken})")
        for q in self.tasks:
            q.put((fn, args, kwargs))
        return self._collect(timeout, getattr(fn, "__name__", "task"))

    def close(self):
        for q, p in zip(self.tasks, self.procs):
            if p.is_alive():
                try:
                    q.put(None)
                except Exception:
                    pass
        for p in self.procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
