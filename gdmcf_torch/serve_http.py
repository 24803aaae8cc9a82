"""HTTP serving over :class:`gdmcf_torch.serve.Recommender`.

Port of the JAX package's ``serve_http.py``, standard library only: a
``ThreadingHTTPServer`` whose handlers submit to a request COALESCER, one
dispatcher thread that drains everything queued while the previous
dispatch ran and packs it into one padded ``serve_batch`` dispatch. That
thread makes every launch on the card; HTTP handler threads never touch it
(a ``/reload`` copies the new parameters from its handler thread and swaps
them under the recommender's dispatch lock). Requests with different ``k``
and ``exclude_history`` share a dispatch: each dispatch ranks ``k_max``
items and the history mask is per row. Under load N concurrent 1-user
requests cost about one dispatch instead of N; when idle nothing waits (no
batching delay: the previous dispatch's duration is the gather window).

Endpoints:
  GET  /healthz                          -> {"ok": true, "n_user": N, ...}
  GET  /recommend?users=1,2,3&k=20       -> {"users": [...], "items": [[...]]}
  POST /recommend  {"users": [...], "k": 20, "exclude_history": true}
  POST /reload     {"ckpt_dir": "..."?}  -> swap in the parameters of a
       same-shape checkpoint with no dropped request (409 when refused: the
       old parameters keep serving); SIGHUP to the daemon reloads from the
       configured checkpoint directory

Run:  python -m gdmcf_torch.serve_http -c configs/amazonOneEmbGcn.yaml \
          --device cuda --data_path DIR --ckpt_dir_serve CK --port 8080
      (--procs N: N pre-forked fronts, see ``serve_front``; --device cpu
      serves from the CPU)

On a (dp, mp) mesh every rank runs this command (``--mesh_dp D --mesh_mp
M``, one process per rank under COORDINATOR_ADDRESS / NUM_PROCESSES /
PROCESS_ID; DIST_BACKEND=gloo and ``--device cuda:0`` for ranks that share
one card). The main rank owns the socket, the coalescer and the fronts;
the other ranks run ``Recommender.follow``. SIGHUP to the main rank is a
reload of every rank, SIGTERM stops every rank (each exits 0), and a rank
that loses the main rank exits non-zero once the process group's timeout
(HEARTBEAT_TIMEOUT_S) passes.
"""

from __future__ import annotations

import os
import threading

import numpy as np


class _Waiter:
    __slots__ = ("users", "exclude", "done", "result", "error")

    def __init__(self, users, exclude: bool):
        self.users = users
        self.exclude = exclude
        self.done = threading.Event()
        self.result = None
        self.error: Exception | None = None


class _Call:
    """A function queued to run on the dispatcher thread (``call``)."""

    __slots__ = ("fn", "done", "result", "error")

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.error: Exception | None = None

    def run(self) -> None:
        try:
            self.result = self.fn()
        except Exception as e:   # re-raised on the caller's thread
            self.error = e
        self.done.set()


class Coalescer:
    """Packs concurrent recommend() requests into shared padded dispatches.

    A single daemon thread owns the card: it takes the FIFO prefix of queued waiters that fits ``serve_batch``
    rows, runs ONE :meth:`Recommender.recommend_batch`, and distributes row
    slices back. Oversized requests are split into serve_batch-sized
    waiters at submit time and reassembled.

    Over a mesh recommender the same thread issues every collective of the
    main rank: the recommender's reloads and its stop come through this
    queue (``call``, set as the recommender's ``ordered``), in order with
    the dispatches, and while no work comes for ``heartbeat_s`` it sends a
    heartbeat, so the other ranks' wait for an op never reaches the
    process group's timeout.
    """

    def __init__(self, recommender):
        self.rec = recommender
        self._cv = threading.Condition()
        from collections import deque
        # waiters and calls, O(1) FIFO popleft
        self._pending: "deque[_Waiter | _Call]" = deque()
        # observability: served request/row/dispatch counters (/healthz)
        self.stats = {"requests": 0, "rows": 0, "dispatches": 0,
                      "coalesced": 0, "heartbeats": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gdmcf-serve-dispatch")
        if recommender.channel is not None:
            recommender.ordered = self.call
        self._thread.start()

    def call(self, fn):
        """Run ``fn`` on the dispatcher thread, queued behind the work
        already pending; returns its result or raises its error. On the
        dispatcher thread itself it runs at once."""
        if threading.current_thread() is self._thread:
            return fn()
        c = _Call(fn)
        with self._cv:
            self._pending.append(c)
            self._cv.notify()
        c.done.wait()
        if c.error is not None:
            raise c.error
        return c.result

    def close(self) -> None:
        """Stop a mesh recommender's other ranks, after the work queued
        before (a no-op on one process)."""
        self.rec.stop()

    def submit(self, users, k: int, exclude: bool):
        """Blocking: returns the [n, k] item matrix for this request.

        Validates ids HERE, the choke point every entry path funnels
        through (HTTP handler, the fronts' unix-socket RPC, in-process
        calls): the RPC forwards unpickled client ids, and an id out of
        range must never reach the history gather of the process that owns
        the card."""
        users = np.asarray(users, dtype=np.int64)
        if users.size == 0:
            raise ValueError("empty users list")
        n_user = self.rec.history.n_user
        if users.min() < 0 or users.max() >= n_user:
            raise ValueError(
                f"user ids must be in [0, {n_user}); got range "
                f"[{int(users.min())}, {int(users.max())}]")
        bs = self.rec.serve_batch
        waiters = [_Waiter(users[i:i + bs], exclude)
                   for i in range(0, users.size, bs)]
        with self._cv:
            self._pending.extend(waiters)
            self.stats["requests"] += 1
            self.stats["rows"] += int(users.size)
            self._cv.notify()
        parts = []
        for w in waiters:
            w.done.wait()
            if w.error is not None:
                raise w.error
            parts.append(w.result[:, :k])
        return np.concatenate(parts, axis=0)

    def _take_batch(self):
        """The next work: the FIFO prefix of waiters that fits one dispatch,
        a queued ``_Call``, or None when a mesh recommender has been idle
        for its ``heartbeat_s``."""
        beat = self.rec.heartbeat_s()
        with self._cv:
            while not self._pending:
                if not self._cv.wait(timeout=beat):
                    return None
            if isinstance(self._pending[0], _Call):
                return self._pending.popleft()
            batch, room = [], self.rec.serve_batch
            while (self._pending and isinstance(self._pending[0], _Waiter)
                   and self._pending[0].users.size <= room):
                batch.append(self._pending.popleft())
                room -= batch[-1].users.size
            return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None or isinstance(batch, _Call):
                try:
                    if batch is None:
                        self.rec.heartbeat()
                        self.stats["heartbeats"] += 1
                    else:
                        batch.run()
                except Exception as e:   # a lost rank: requests now fail
                    print(f"heartbeat failed: {type(e).__name__}: {e}",
                          flush=True)
                continue
            # EVERYTHING after take is guarded: this is the sole dispatcher
            # thread, and an unguarded failure (a MemoryError in the
            # concatenates) would kill it silently, wedging every queued
            # and future request while /healthz stayed green
            try:
                users = np.concatenate([w.users for w in batch])
                excl = np.concatenate([np.full(w.users.size, w.exclude,
                                               bool) for w in batch])
                with self._cv:
                    self.stats["dispatches"] += 1
                    self.stats["coalesced"] += len(batch) - 1
                ranked = self.rec.recommend_batch(users, excl)
            except Exception as e:  # surface to every caller in this batch
                for w in batch:
                    w.error = e
                    w.done.set()
                continue
            off = 0
            for w in batch:
                w.result = ranked[off:off + w.users.size]
                off += w.users.size
                w.done.set()


def make_server(recommender, host: str = "127.0.0.1", port: int = 8080):
    """Build (not start) the HTTP server (a ``serve_front.HTTPServer``);
    ``.serve_forever()`` to run."""
    from gdmcf_torch.serve_front import HTTPServer, make_handler

    coalescer = Coalescer(recommender)
    limits = {"n_user": recommender.history.n_user,
              "n_item": recommender.history.n_item,
              "serve_batch": recommender.serve_batch,
              "k_max": recommender.k_max}
    handler = make_handler(
        limits, coalescer.submit,
        lambda: {**coalescer.stats,
                 "params_version": recommender.params_version},
        reload=recommender.reload_params)
    srv = HTTPServer((host, port), handler)
    srv.coalescer = coalescer  # type: ignore[attr-defined]  (introspection)
    return srv


def serve_multiproc(recommender, host: str, port: int, procs: int,
                    sock_path: "str | None" = None):
    """N pre-forked SO_REUSEPORT HTTP fronts + this process (which owns the
    card) as the coalescing backend. Returns (Backend, [Popen fronts]); blocks only in
    ``main``. See serve_front docstring for the architecture."""
    import tempfile

    from gdmcf_torch.serve_front import Backend, spawn_fronts

    if port == 0:
        raise ValueError("multiproc mode needs an explicit --port "
                         "(SO_REUSEPORT fronts must agree on it)")
    coalescer = Coalescer(recommender)
    # pid alone collides when one process stands up two servers (and a
    # crashed predecessor's stale path would be unlinked out from under a
    # LIVE backend by Backend.__init__) — salt with a uuid
    import uuid

    sock_path = sock_path or os.path.join(
        tempfile.gettempdir(),
        f"gdmcf_serve_{os.getpid()}_{uuid.uuid4().hex[:8]}.sock")
    backend = Backend(coalescer, recommender, sock_path)
    fronts = spawn_fronts(procs, sock_path, host, port)
    return backend, fronts


def supervise_fronts(backend, fronts, host: str, port: int,
                     max_restarts: "int | None" = None, poll_s: float = 1.0,
                     stop_event=None) -> None:
    """Supervise pre-forked fronts: a dead front silently degrades capacity
    (the very tail problem the fronts fix), so respawn it — bounded, to
    fail loudly on a crash loop (e.g. the port became unbindable) instead
    of spinning. Blocks until ``stop_event`` is set (forever if None);
    raises RuntimeError when the restart budget runs out. Mutates
    ``fronts`` in place so the caller's handles stay current."""
    import time as _time

    from gdmcf_torch.serve_front import spawn_fronts

    budget = 3 * len(fronts) if max_restarts is None else max_restarts
    window_s = 300.0
    recent = []  # restart timestamps inside the sliding window
    while stop_event is None or not stop_event.is_set():
        _time.sleep(poll_s)
        for i, p in enumerate(fronts):
            rc = p.poll()
            if rc is None:
                continue
            # crash-LOOP detector, not a lifetime fuse: the budget applies
            # to restarts within a sliding window, so isolated crashes
            # spread over days (a host OOM killer) never exhaust it and
            # tear the whole serving group down
            now = _time.monotonic()
            recent = [t for t in recent if now - t < window_s]
            if len(recent) >= budget:
                raise RuntimeError(
                    f"front pid {p.pid} exited rc={rc}: {len(recent)} "
                    f"restarts inside {window_s:.0f} s — crash loop, "
                    "shutting down")
            recent.append(now)
            print(f"front pid {p.pid} exited rc={rc}; respawning "
                  f"({budget - len(recent)} window restarts left)",
                  flush=True)
            fronts[i] = spawn_fronts(1, backend.sock_path, host, port)[0]


def main(argv=None):
    import argparse
    import signal
    import sys

    from gdmcf_torch.config import parse_args
    from gdmcf_torch.data.loader import data_load_dir
    from gdmcf_torch.serve import build_recommender

    args = argv if argv is not None else sys.argv[1:]
    http_flags = argparse.ArgumentParser(add_help=False)
    http_flags.add_argument("--ckpt_dir_serve", default=None)
    http_flags.add_argument("--host", default="127.0.0.1")
    http_flags.add_argument("--port", type=int, default=8080)
    http_flags.add_argument("--serve_batch", type=int, default=256)
    http_flags.add_argument("--k_max", type=int, default=100)
    http_flags.add_argument("--procs", type=int, default=1,
                            help=">1: pre-fork that many SO_REUSEPORT HTTP "
                                 "front processes; this process keeps the "
                                 "card and the coalescer only")
    ns, rest = http_flags.parse_known_args(args)
    cfg = parse_args(rest)   # --device cuda (the default) or cpu

    train, _, _, n_user, n_item = data_load_dir(cfg.data_path)
    rec = build_recommender(cfg, ns.ckpt_dir_serve or cfg.ckpt_dir, train,
                            n_user, n_item, serve_batch=ns.serve_batch,
                            k_max=ns.k_max)
    from gdmcf_torch.parallel.multihost import shutdown

    if not rec.is_main:
        # a mesh rank: the main rank's ops until its stop; it exits
        # non-zero once it loses the main rank
        rec.follow()
        shutdown()
        return

    # an operator reloads without knowing the HTTP port: SIGHUP restores
    # from the configured checkpoint directory, off the signal frame (the
    # restore reads the disk; traffic never pauses; on a mesh the reload
    # joins the dispatcher's queue)
    def _on_sighup(signum, frame):
        def _do():
            try:
                info = rec.reload_params()
                print(f"SIGHUP reload: {info}", flush=True)
            except Exception as e:
                print(f"SIGHUP reload FAILED (old params stay live): "
                      f"{type(e).__name__}: {e}", flush=True)
        threading.Thread(target=_do, daemon=True).start()

    # the default SIGTERM kills the process without unwinding, orphaning
    # the fronts that hold the port; SystemExit runs the finally blocks
    # below and tears the server down
    def _on_sigterm(signum, frame):
        raise SystemExit(0)

    signal.signal(signal.SIGHUP, _on_sighup)
    signal.signal(signal.SIGTERM, _on_sigterm)

    if ns.procs > 1:
        backend, fronts = serve_multiproc(rec, ns.host, ns.port, ns.procs)
        print(f"serving on http://{ns.host}:{ns.port} "
              f"({ns.procs} fronts, backend pid {os.getpid()}, device "
              f"{rec.trainer.device})", flush=True)
        try:
            supervise_fronts(backend, fronts, ns.host, ns.port)
        finally:
            backend.close()
            for p in fronts:
                p.terminate()
            for p in fronts:
                try:
                    p.wait(timeout=10)
                except Exception:
                    pass
            backend.coalescer.close()
            shutdown()
        return
    srv = make_server(rec, ns.host, ns.port)
    print(f"serving on http://{ns.host}:{srv.server_address[1]} (device "
          f"{rec.trainer.device})", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        srv.coalescer.close()   # a mesh's other ranks stop too
        shutdown()


if __name__ == "__main__":
    main()
