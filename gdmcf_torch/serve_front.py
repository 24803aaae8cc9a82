"""Pre-forked HTTP fronts and their RPC to the serving backend (imports
no torch).

Port of the JAX package's ``serve_front.py``. ``serve_http --procs N``
starts N FRONT processes that bind the same TCP port with
``SO_REUSEPORT`` (the kernel balances accepts, no load balancer needed) and
forward each request over a unix-domain socket to the one BACKEND process,
which owns the card and runs only the request coalescer and its dispatcher.
HTTP parsing and JSON serialization then burn the fronts' interpreters, not
the dispatcher's.

The RPC is length-prefixed pickles of numpy arrays over persistent pooled
connections (one request in flight per connection; a front grows its pool
on demand). A front imports neither torch nor anything that touches the
card: it starts in a fraction of a second, holds little memory, and can
never race the backend for the device.

The handler logic is shared with the single-process server
(:mod:`gdmcf_torch.serve_http`) through :func:`make_handler`.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import socketserver
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_LEN = struct.Struct(">I")


class BackendUnreachable(RuntimeError):
    """Front->backend RPC transport failed: distinct from a REFUSED
    operation (backend alive, said no). A refused /reload is 409 ("old
    params keep serving" — true); an unreachable backend is 502 (nothing
    is serving; FileNotFoundError from a missing checkpoint must NOT land
    here, which is why this is a dedicated type rather than OSError)."""


def _send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_msg(sock: socket.socket):
    header = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(header)
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("backend connection closed")
        buf.extend(chunk)
    return bytes(buf)


# ---------------------------------------------------------------------------
# backend side (runs in the process that owns the card)
# ---------------------------------------------------------------------------

class Backend:
    """Unix-socket RPC server wrapping a Coalescer.

    Ops (request tuple -> response tuple):
      ("info",)                      -> ("ok", {n_user, n_item, k_max, ...})
      ("recommend", users, k, excl)  -> ("ok", items ndarray [n, k])
      ("reload", ckpt_dir_or_None)   -> ("ok", {reloaded, step, ...})
      any error                      -> ("err", "TypeName: message")
    """

    def __init__(self, coalescer, recommender, sock_path: str):
        self.coalescer = coalescer
        self.rec = recommender
        self.sock_path = sock_path
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(sock_path)
        self._srv.listen(128)
        self._shutdown = False
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="gdmcf-backend-accept")
        self._accept_thread.start()

    def info(self) -> dict:
        return {"n_user": self.rec.history.n_user,
                "n_item": self.rec.history.n_item,
                "serve_batch": self.rec.serve_batch,
                "k_max": self.rec.k_max,
                "stats": {**self.coalescer.stats,
                          "params_version": self.rec.params_version}}

    def _accept_loop(self):
        while not self._shutdown:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            self._serve_conn_inner(conn)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def _serve_conn_inner(self, conn: socket.socket):
        with conn:
            while True:
                try:
                    msg = _recv_msg(conn)
                except (ConnectionError, EOFError, OSError):
                    return
                except Exception:
                    # corrupt frame (e.g. UnpicklingError from a truncated
                    # write or a stray local process on the socket): the
                    # stream framing is lost, so no reply is possible —
                    # drop the connection instead of killing this thread
                    # with an unhandled traceback
                    return
                try:
                    if msg[0] == "info":
                        reply = ("ok", self.info())
                    elif msg[0] == "recommend":
                        _, users, k, exclude = msg
                        items = self.coalescer.submit(users, int(k),
                                                      bool(exclude))
                        reply = ("ok", items)
                    elif msg[0] == "reload":
                        # hot-swap the backend's parameters; any
                        # front can forward the operator's POST /reload here
                        reply = ("ok", self.rec.reload_params(msg[1]))
                    else:
                        reply = ("err", f"unknown op {msg[0]!r}")
                except Exception as e:  # surfaced as a 500 by the front
                    reply = ("err", f"{type(e).__name__}: {e}")
                try:
                    _send_msg(conn, reply)
                except OSError:
                    return

    def close(self):
        """Stop accepting AND sever live connections — a closed backend
        must look DEAD to its fronts (their watchdogs key off it), not
        half-alive through surviving per-connection threads."""
        self._shutdown = True
        try:
            self._srv.close()
        finally:
            with self._conns_lock:
                conns = list(self._conns)
            for c in conns:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass
            if os.path.exists(self.sock_path):
                os.unlink(self.sock_path)


# ---------------------------------------------------------------------------
# front side (worker processes without torch)
# ---------------------------------------------------------------------------

class _ConnPool:
    """Persistent backend connections, one in-flight request each."""

    def __init__(self, sock_path: str):
        self.sock_path = sock_path
        self._free: list[socket.socket] = []
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(self.sock_path)
        return s

    def call(self, msg):
        with self._lock:
            conn = self._free.pop() if self._free else None
        if conn is None:
            conn = self._connect()
        try:
            _send_msg(conn, msg)
            reply = _recv_msg(conn)
        except (ConnectionError, OSError):
            conn.close()
            raise
        with self._lock:
            self._free.append(conn)
        if reply[0] != "ok":
            raise RuntimeError(reply[1])
        return reply[1]


class HTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog for many clients: the
    standard library's 5 overflows under a few dozen concurrent
    connections, and each connection the kernel drops waits out a SYN
    retransmission (1 s, then 3 s, 7 s ...) before it is even accepted."""

    request_queue_size = 1024


class ReusePortHTTPServer(HTTPServer):
    """HTTPServer binding with SO_REUSEPORT so N processes share one port
    (kernel accept balancing)."""

    def server_bind(self):
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        socketserver.TCPServer.server_bind(self)


def make_handler(limits: dict, submit, stats, reload=None):
    """HTTP handler factory shared by the single-process server and the
    pre-forked fronts.

    ``limits``: {"n_user", "n_item", "serve_batch", "k_max"} for validation
    and /healthz. ``submit(users, k, exclude) -> ndarray [n, k]``;
    ``stats() -> dict`` merged into /healthz. ``reload(ckpt_dir|None) ->
    dict`` hot-swaps the serving params from a checkpoint (POST /reload,
    optional JSON body {"ckpt_dir": ...}); omitted -> 501.
    """

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _recommend(self, users, k: int, exclude: bool) -> None:
            if not users:
                self._reply(400, {"error": "users must be non-empty"})
                return
            if not 1 <= k <= limits["k_max"]:
                self._reply(400, {"error": f"k must be in [1, "
                                           f"{limits['k_max']}] (k_max)"})
                return
            bad = [u for u in users if not 0 <= u < limits["n_user"]]
            if bad:
                self._reply(400,
                            {"error": f"user ids out of range: {bad[:5]}"})
                return
            try:
                items = submit(np.asarray(users, dtype=np.int32), k, exclude)
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, {"users": [int(u) for u in users],
                              "items": [[int(i) for i in row]
                                        for row in items]})

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._reply(200, {"ok": True,
                                  "n_user": limits["n_user"],
                                  "n_item": limits["n_item"],
                                  "serve_batch": limits["serve_batch"],
                                  "k_max": limits["k_max"],
                                  "stats": stats()})
                return
            if url.path == "/recommend":
                q = parse_qs(url.query)
                try:
                    users = [int(u)
                             for u in q.get("users", [""])[0].split(",")
                             if u != ""]
                    k = int(q.get("k", ["20"])[0])
                    exclude = (q.get("exclude_history", ["true"])[0]
                               .strip().lower() in ("1", "true", "yes", "y"))
                except ValueError:
                    self._reply(400, {"error": "malformed query"})
                    return
                self._recommend(users, k, exclude)
                return
            self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/reload":
                if reload is None:
                    self._reply(501, {"error": "reload not supported here"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    ckpt_dir = req.get("ckpt_dir") if isinstance(req, dict) \
                        else None
                except (ValueError, json.JSONDecodeError):
                    self._reply(400, {"error": "body must be JSON"})
                    return
                try:
                    self._reply(200, reload(ckpt_dir))
                except BackendUnreachable as e:
                    # transport-level failure (front->backend RPC died):
                    # we do NOT know the params state and traffic is
                    # likely failing too — this must not read as a clean
                    # "refused, old tree still serving"
                    self._reply(502, {"error": f"backend unreachable: {e}"})
                except Exception as e:
                    # live params are untouched on any failure; 409 = the
                    # swap was refused, traffic keeps serving the old tree
                    self._reply(409, {"error": f"{type(e).__name__}: {e}"})
                return
            if url.path != "/recommend":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                users = [int(u) for u in req["users"]]
                k = int(req.get("k", 20))
                exclude = bool(req.get("exclude_history", True))
            except (KeyError, TypeError, ValueError, json.JSONDecodeError):
                self._reply(400, {"error": "body must be JSON with 'users'"})
                return
            self._recommend(users, k, exclude)

    return Handler


def front_serve(sock_path: str, host: str, port: int,
                watchdog_interval: float = 2.0,
                watchdog_failures: int = 5) -> None:
    """Run one front process: RPC pool to the backend + SO_REUSEPORT HTTP.

    A watchdog thread pings the backend; after ``watchdog_failures``
    consecutive failures the front exits (rc 3). Without it, a dead
    backend leaves N orphaned fronts holding the port and answering every
    request with a 500 forever — the supervisor (or operator) owns
    restarts, fronts own dying cleanly."""
    import time

    pool = _ConnPool(sock_path)
    deadline = time.time() + 60.0
    info = None
    while time.time() < deadline:
        try:
            info = pool.call(("info",))
            break
        except (FileNotFoundError, ConnectionError, OSError):
            time.sleep(0.1)
    if info is None:
        raise SystemExit(f"front: backend at {sock_path} never came up")

    def submit(users, k, exclude):
        return pool.call(("recommend", users, k, exclude))

    def stats():
        return pool.call(("info",))["stats"]

    def reload(ckpt_dir):
        try:
            return pool.call(("reload", ckpt_dir))
        except (ConnectionError, OSError, EOFError) as e:
            # transport failure front->backend, NOT a refused swap: the
            # params state is unknown and /recommend is failing too
            raise BackendUnreachable(f"{type(e).__name__}: {e}") from e

    def watchdog():
        misses = 0
        # a dedicated pool: liveness probes must not contend with (or be
        # blocked behind) in-flight request connections
        wd_pool = _ConnPool(sock_path)
        while True:
            time.sleep(watchdog_interval)
            try:
                wd_pool.call(("info",))
                misses = 0
            except Exception:
                misses += 1
                if misses >= watchdog_failures:
                    print(f"front pid {os.getpid()}: backend at "
                          f"{sock_path} unreachable x{misses}; exiting",
                          flush=True)
                    os._exit(3)

    threading.Thread(target=watchdog, daemon=True,
                     name="gdmcf-front-watchdog").start()
    handler = make_handler(info, submit, stats, reload=reload)
    srv = ReusePortHTTPServer((host, port), handler)
    srv.serve_forever()


def spawn_fronts(n: int, sock_path: str, host: str, port: int,
                 watchdog_interval: "float | None" = None,
                 watchdog_failures: "int | None" = None) -> list:
    """Start N front subprocesses (``python -m gdmcf_torch.serve_front``)
    with the package's root on their path and no visible CUDA device (a
    front never touches the card; the backend owns it). Returns the Popen
    handles; the caller terminates them."""
    import subprocess
    import sys

    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo_root not in parts:
        parts.insert(0, repo_root)
    env["PYTHONPATH"] = os.pathsep.join(parts)
    cmd = [sys.executable, "-m", "gdmcf_torch.serve_front",
           "--sock", sock_path, "--host", host, "--port", str(port)]
    if watchdog_interval is not None:
        cmd += ["--watchdog-interval", str(watchdog_interval)]
    if watchdog_failures is not None:
        cmd += ["--watchdog-failures", str(watchdog_failures)]
    procs = []
    for _ in range(n):
        procs.append(subprocess.Popen(cmd, env=env))
    return procs


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--sock", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--watchdog-interval", type=float, default=2.0)
    ap.add_argument("--watchdog-failures", type=int, default=5)
    ns = ap.parse_args(argv)
    front_serve(ns.sock, ns.host, ns.port,
                watchdog_interval=ns.watchdog_interval,
                watchdog_failures=ns.watchdog_failures)


if __name__ == "__main__":
    main()
