"""The port's HTTP serving (``serve_http``, ``serve_front``) and hot reload
(``Recommender.reload_params``) on ``device="cpu"``: every behaviour that
``tests/test_serve_http.py`` pins for the JAX package, against an
in-process server, pre-forked fronts and the daemon; one test holds the
port's answers against the JAX package's server at equal weights (same
users, same ids).

Every blocking call has a timeout and every subprocess is killed in a
``finally``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gdmcf_torch.config import Config  # noqa: E402
from gdmcf_torch.data.loader import (data_load,  # noqa: E402
                                     generate_synthetic_dataset)
from gdmcf_torch.serve import Recommender  # noqa: E402
from gdmcf_torch.serve_http import make_server  # noqa: E402
from gdmcf_torch.train.checkpoint import Checkpointer  # noqa: E402
from gdmcf_torch.train.trainer import Trainer  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG = dict(backbone="DNNOneHotEmbeddingGCN", dims=[16], emb_size=10,
           steps=5, batch_size=8, sampling_steps=0, device="cpu")


@pytest.fixture(scope="module")
def train_csr(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("http")
    paths = generate_synthetic_dataset(str(tmp), n_user=40, n_item=32,
                                       avg_degree=6, seed=9)
    return data_load(*paths)[0]


@pytest.fixture(scope="module")
def server(train_csr):
    train = train_csr
    n_user, n_item = train.shape
    trainer = Trainer(Config(**CFG), n_user, n_item)
    rec = Recommender.from_state(trainer, None, train, serve_batch=8)
    srv = make_server(rec, "127.0.0.1", 0)   # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield rec, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, payload: bytes, timeout=120):
    req = urllib.request.Request(url, data=payload,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _wait_up(base, proc=None, limit=60.0):
    deadline = time.time() + limit
    while time.time() < deadline:
        if proc is not None:
            assert proc.poll() is None, "server died during start-up"
        try:
            return _get(base + "/healthz")[1]
        except OSError:
            time.sleep(0.2)
    raise AssertionError(f"{base} never came up")


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def _run_threads(threads, limit=60.0):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=limit)
        assert not t.is_alive(), "a request thread hung"


def _live(rec):
    return {k: p.detach().clone()
            for k, p in rec.trainer.model.named_parameters()}


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _checkpoint(tmp_path, name, step, shift=0.0, **cfg_kw):
    """A checkpoint of a fresh Trainer of the fixture's geometry (another
    seed, every parameter shifted by ``shift``) at ``step``; returns (its
    directory, its parameters)."""
    trainer = Trainer(Config(**{**CFG, "random_seed": 5, **cfg_kw}), 40, 32)
    state = trainer.init_state()
    with torch.no_grad():
        for p in state.params.values():
            p.add_(shift)
    state.step = step
    ckpt_dir = str(tmp_path / name)
    ck = Checkpointer(ckpt_dir)
    ck.save(state)
    ck.close()
    return ckpt_dir, {k: p.detach().clone() for k, p in state.params.items()}


def test_healthz(server):
    _, base = server
    code, body = _get(base + "/healthz")
    assert code == 200
    assert body["ok"] and body["n_user"] == 40 and body["n_item"] == 32
    assert body["stats"]["params_version"] == 0


def test_get_recommend_matches_library(server):
    rec, base = server
    code, body = _get(base + "/recommend?users=0,3,7&k=5")
    assert code == 200
    direct, _ = rec.recommend([0, 3, 7], k=5)
    np.testing.assert_array_equal(np.asarray(body["items"]), direct)
    assert body["users"] == [0, 3, 7]


def test_post_recommend(server):
    _, base = server
    _, body = _post(base + "/recommend",
                    json.dumps({"users": [1, 2], "k": 4}).encode())
    assert len(body["items"]) == 2 and len(body["items"][0]) == 4


def test_errors(server):
    _, base = server
    for path in ("/recommend?users=&k=5",       # empty users
                 "/recommend?users=999&k=5",    # out of range
                 "/recommend?users=x&k=5",      # malformed
                 "/recommend?users=1&k=0",      # k out of range
                 "/recommend?users=1&k=99999",  # k > k_max
                 "/nope"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + path)
        assert e.value.code in (400, 404)


def test_post_bad_bodies_return_400(server):
    """Non-dict JSON, non-list users, no JSON at all: 400, and the handler
    lives on."""
    _, base = server
    for body in (b"[1,2]", b'{"users": 5}', b"not json", b""):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/recommend", body, timeout=60)
        assert e.value.code == 400
    assert _get(base + "/healthz")[0] == 200


def test_coalescer_refuses_out_of_range_ids(server):
    """Ids are bounds-checked at submit, the choke point of every entry
    path (the fronts' RPC included)."""
    rec, base = server
    from gdmcf_torch.serve_http import Coalescer

    coalescer = Coalescer(rec)
    for users in ([], [-1], [40], [0, 999]):
        with pytest.raises(ValueError):
            coalescer.submit(users, 3, True)
    assert coalescer.submit([0, 39], 3, True).shape == (2, 3)


def test_k_prefix_of_kmax_ranking_is_exact(server):
    """The k_max ranking cut to k equals a recommender built at k_max k."""
    rec, _ = server
    items_sliced, _ = rec.recommend([0, 5, 9], k=4)
    direct = Recommender(rec.trainer, rec.history,
                         serve_batch=rec.serve_batch, k_max=4)
    items_direct, _ = direct.recommend([0, 5, 9], k=4)
    np.testing.assert_array_equal(items_sliced, items_direct)


def test_concurrent_requests(server):
    """Concurrent requests coalesce into shared dispatches and all succeed
    with the library's ids."""
    rec, base = server
    results = {}

    def hit(u):
        results[u] = _get(base + f"/recommend?users={u}&k=3")

    _run_threads([threading.Thread(target=hit, args=(u,)) for u in range(6)])
    assert [results[u][0] for u in range(6)] == [200] * 6
    for u in range(6):
        np.testing.assert_array_equal(results[u][1]["items"],
                                      rec.recommend([u], k=3)[0])


def test_coalescer_mixed_k_and_exclude(server):
    """Requests with different k and exclude_history share dispatches yet
    each gets its own slice (per-row mask, per-request k cut)."""
    rec, base = server
    out = {}

    def hit(name, qs):
        out[name] = _get(base + "/recommend?" + qs)[1]

    _run_threads([
        threading.Thread(target=hit, args=("a", "users=0,1&k=3")),
        threading.Thread(target=hit,
                         args=("b", "users=2&k=5&exclude_history=false")),
        threading.Thread(target=hit, args=("c", "users=3,4,5&k=2")),
    ])
    assert [len(r) for r in out["a"]["items"]] == [3, 3]
    assert [len(r) for r in out["b"]["items"]] == [5]
    assert [len(r) for r in out["c"]["items"]] == [2, 2, 2]
    assert out["a"]["users"] == [0, 1]
    assert out["c"]["users"] == [3, 4, 5]
    # excluded-history rows never rank a seen item
    seen = set(np.flatnonzero(rec.history.gather(np.array([0]))[0]).tolist())
    assert not seen.intersection(out["a"]["items"][0])
    np.testing.assert_array_equal(
        out["b"]["items"], rec.recommend([2], k=5, exclude_history=False)[0])


def test_mixed_requests_share_one_dispatch(server):
    """Held behind one slow dispatch, requests of different k and
    exclude_history queue and then go out together in a single dispatch."""
    rec, base = server
    coalescer_stats = lambda: _get(base + "/healthz")[1]["stats"]  # noqa
    gate = threading.Event()
    orig = rec.recommend_batch

    def slow(users, exclude_rows):
        gate.wait(timeout=30)
        return orig(users, exclude_rows)

    rec.recommend_batch = slow
    out = {}
    try:
        def hit(name, qs):
            out[name] = _get(base + "/recommend?" + qs)[1]

        first = threading.Thread(target=hit, args=("first", "users=9&k=2"))
        first.start()
        time.sleep(0.3)     # the dispatcher now waits inside ``slow``
        before = coalescer_stats()
        rest = [threading.Thread(target=hit, args=(n, q)) for n, q in (
            ("a", "users=0,1&k=3"),
            ("b", "users=2&k=5&exclude_history=false"),
            ("c", "users=3&k=1"))]
        for t in rest:
            t.start()
        deadline = time.time() + 30
        while coalescer_stats()["requests"] < before["requests"] + 3:
            assert time.time() < deadline, "requests never queued"
            time.sleep(0.05)
        gate.set()
        for t in [first] + rest:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        gate.set()
        rec.recommend_batch = orig
    after = coalescer_stats()
    # the three queued requests went out in one dispatch of 4 rows
    assert after["dispatches"] == before["dispatches"] + 1
    assert after["coalesced"] >= before["coalesced"] + 2
    assert [len(r) for r in out["a"]["items"]] == [3, 3]
    np.testing.assert_array_equal(
        out["b"]["items"], rec.recommend([2], k=5, exclude_history=False)[0])
    np.testing.assert_array_equal(out["c"]["items"],
                                  rec.recommend([3], k=1)[0])


def test_coalescer_stats_and_oversized_split(server):
    """A request wider than serve_batch (8) splits into several dispatches
    and reassembles in order; /healthz exposes the counters."""
    rec, base = server
    before = _get(base + "/healthz")[1]["stats"]
    users = [u % 40 for u in range(20)]
    code, body = _get(base + "/recommend?users=" +
                      ",".join(map(str, users)) + "&k=3")
    assert code == 200
    assert len(body["items"]) == 20 and len(body["items"][0]) == 3
    np.testing.assert_array_equal(body["items"], rec.recommend(users, k=3)[0])
    after = _get(base + "/healthz")[1]["stats"]
    assert after["requests"] == before["requests"] + 1
    assert after["rows"] == before["rows"] + 20
    # 20 rows at serve_batch 8: at least ceil(20 / 8) = 3 dispatches
    assert after["dispatches"] >= before["dispatches"] + 3


def test_get_exclude_history_false_variants(server):
    """GET exclude_history takes the config's truthy convention: 'False',
    '0' and 'no' disable the history mask."""
    rec, base = server
    with_hist, _ = rec.recommend([0], k=5, exclude_history=False)
    for v in ("false", "False", "0", "no"):
        code, body = _get(base + f"/recommend?users=0&k=5&exclude_history={v}")
        assert code == 200
        np.testing.assert_array_equal(np.asarray(body["items"]), with_hist)
    masked, _ = rec.recommend([0], k=5, exclude_history=True)
    code, body = _get(base + "/recommend?users=0&k=5&exclude_history=true")
    np.testing.assert_array_equal(np.asarray(body["items"]), masked)


def test_coalescer_error_propagates_and_recovers(server):
    """A dispatch failure reaches every waiter of its batch as a 500 (never
    a hang), and the dispatcher thread lives on to serve the next
    request."""
    rec, base = server
    orig = rec.recommend_batch
    calls = {"n": 0}

    def boom(users, exclude_rows):
        calls["n"] += 1
        raise RuntimeError("injected dispatch failure")

    rec.recommend_batch = boom
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/recommend?users=0,1&k=3")
        assert e.value.code == 500 and calls["n"] == 1
        assert "injected dispatch failure" in json.loads(e.value.read())[
            "error"]
    finally:
        rec.recommend_batch = orig
    code, body = _get(base + "/recommend?users=2&k=3")
    assert code == 200 and len(body["items"][0]) == 3


@pytest.mark.parametrize("reuse_port", [False, True])
def test_listen_backlog_takes_a_burst_of_clients(server, reuse_port):
    """64 clients connecting at once all complete their handshake while the
    server accepts nothing yet: the standard library's backlog of 5 would
    leave the rest waiting out SYN retransmissions (1 s, 3 s, ...)."""
    from http.server import BaseHTTPRequestHandler

    from gdmcf_torch.serve_front import HTTPServer, ReusePortHTTPServer

    cls = ReusePortHTTPServer if reuse_port else HTTPServer
    srv = cls(("127.0.0.1", 0), BaseHTTPRequestHandler)
    socks = []
    try:
        for _ in range(64):
            socks.append(socket.create_connection(srv.server_address,
                                                  timeout=2))
    finally:
        for sk in socks:
            sk.close()
        srv.server_close()
    assert len(socks) == 64
    made = make_server(server[0], "127.0.0.1", 0)
    try:
        assert isinstance(made, HTTPServer)
    finally:
        made.server_close()


def test_row_ids_do_not_depend_on_the_rows_batched_with_it(server):
    """A user's ids alone and coalesced with unrelated users in one padded
    dispatch are the same (the flagship's directed GCN keeps user rows
    apart)."""
    rec, _ = server
    rng = np.random.default_rng(3)
    for u in (0, 7, 39):
        others = rng.choice([v for v in range(40) if v != u], 7,
                            replace=False)
        together = rec.recommend_batch(np.r_[others[:3], u, others[3:]],
                                       np.ones(8, bool))[3]
        alone = rec.recommend_batch([u], np.ones(1, bool))[0]
        np.testing.assert_array_equal(together, alone)


# ---------------------------------------------------------------------------
# hot reload
# ---------------------------------------------------------------------------

def test_hot_reload_swaps_params_without_downtime(server, tmp_path):
    """POST /reload swaps in a same-shape checkpoint with zero failed
    requests: the live parameters become the checkpoint's bitwise, the
    rankings change, /healthz's params_version goes up by one, and traffic
    during the swap all answers 200."""
    rec, base = server
    orig = _live(rec)
    ckpt_dir, saved = _checkpoint(tmp_path, "hot", 123, shift=0.01)
    before = _get(base + "/healthz")[1]["stats"]["params_version"]
    codes = []

    def traffic():
        for u in range(5):
            codes.append(_get(base + f"/recommend?users={u}&k=3")[0])

    t = threading.Thread(target=traffic)
    t.start()
    try:
        _, body = _post(base + "/reload",
                        json.dumps({"ckpt_dir": ckpt_dir}).encode())
        t.join(timeout=60)
        assert not t.is_alive()
        assert body["reloaded"] and body["step"] == 123
        assert codes == [200] * 5
        after = _get(base + "/healthz")[1]["stats"]["params_version"]
        assert after == before + 1 == body["params_version"]
        assert _equal(_live(rec), saved)
        assert rec.ckpt_dir == ckpt_dir
        new_items, _ = rec.recommend([0, 1, 2], k=5)
        rec._swap(orig)
        old_items, _ = rec.recommend([0, 1, 2], k=5)
        assert not np.array_equal(new_items, old_items)
    finally:
        rec._swap(orig)
        rec.ckpt_dir = None   # demo mode again for the later tests


def test_hot_reload_failure_leaves_old_params_live(server, tmp_path):
    """A refused reload (no directory configured, a missing one) is a 409,
    and the old parameters keep serving: the swap is all or nothing."""
    rec, base = server
    orig = _live(rec)
    ptrs = [p.data_ptr() for p in rec.trainer.model.parameters()]
    for payload in (b"{}",   # demo mode has no checkpoint directory
                    json.dumps({"ckpt_dir": str(tmp_path / "nope")}).encode()):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/reload", payload)
        assert e.value.code == 409
    assert not (tmp_path / "nope").exists()
    assert _equal(_live(rec), orig)
    assert ptrs == [p.data_ptr() for p in rec.trainer.model.parameters()]
    assert _get(base + "/recommend?users=0&k=3")[0] == 200


def test_hot_reload_rejects_mismatched_shapes(server, tmp_path):
    """A checkpoint of another geometry is refused with the live parameters
    untouched."""
    rec, _ = server
    ckpt_dir, _ = _checkpoint(tmp_path, "mismatch", 1, dims=[8])
    orig = _live(rec)
    version = rec.params_version
    with pytest.raises(ValueError, match="another geometry"):
        rec.reload_params(ckpt_dir)
    assert _equal(_live(rec), orig) and rec.params_version == version


def test_reload_reads_only_the_parameters(server, train_csr, tmp_path,
                                          monkeypatch):
    """Neither a reload nor from_checkpoint builds a TrainState (no moments
    are allocated), and a reloaded server answers with the ids of a fresh
    Recommender.from_checkpoint of that checkpoint."""
    rec, _ = server
    ckpt_dir, _ = _checkpoint(tmp_path, "fresh", 9, shift=-0.02)
    orig = _live(rec)

    def no_state(self):
        raise AssertionError("init_state was called")

    monkeypatch.setattr(Trainer, "init_state", no_state)
    try:
        assert rec.reload_params(ckpt_dir)["step"] == 9
        got, _ = rec.recommend(list(range(40)), k=10)
    finally:
        rec._swap(orig)
        rec.ckpt_dir = None
    fresh = Recommender.from_checkpoint(Config(**CFG), ckpt_dir, train_csr,
                                        serve_batch=8)
    assert fresh.ckpt_dir == ckpt_dir and fresh.params_version == 0
    want, _ = fresh.recommend(list(range(40)), k=10)
    np.testing.assert_array_equal(got, want)


def test_coalescer_under_concurrent_submits_and_reloads(server, tmp_path):
    """24 submitting threads (more than the cores) and a thread swapping
    between two parameter sets, with a short switch interval: every row
    carries the ids of one whole set, old or new, and the counters lose no
    update."""
    from gdmcf_torch.serve_http import Coalescer

    rec, _ = server
    orig = _live(rec)
    ckpt_dir, _ = _checkpoint(tmp_path, "stress", 3, shift=0.05)
    users = np.arange(40)
    old = rec.recommend(users, k=5)[0]
    rec.reload_params(ckpt_dir)
    new = rec.recommend(users, k=5)[0]
    rec._swap(orig)
    assert not np.array_equal(old, new)
    coalescer = Coalescer(rec)
    rng = np.random.default_rng(0)
    plans = [[rng.choice(40, rng.integers(1, 4), replace=False)
              for _ in range(6)] for _ in range(24)]
    bad, stop = [], threading.Event()

    def submit(plan):
        for us in plan:
            got = coalescer.submit(us, 5, True)
            for u, row in zip(us, got):
                if not (np.array_equal(row, old[u])
                        or np.array_equal(row, new[u])):
                    bad.append((int(u), row.tolist()))

    def flip():
        while not stop.is_set():
            rec.reload_params(ckpt_dir)
            rec._swap(orig)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    flipper = threading.Thread(target=flip)
    try:
        flipper.start()
        _run_threads([threading.Thread(target=submit, args=(p,))
                      for p in plans], limit=120)
    finally:
        stop.set()
        flipper.join(timeout=60)
        sys.setswitchinterval(interval)
        rec._swap(orig)
        rec.ckpt_dir = None
    assert not flipper.is_alive() and not bad, bad[:3]
    assert coalescer.stats["requests"] == 24 * 6
    assert coalescer.stats["rows"] == sum(len(us) for p in plans for us in p)


# ---------------------------------------------------------------------------
# pre-forked fronts
# ---------------------------------------------------------------------------

def test_multiproc_front_end_to_end(server):
    """Two front PROCESSES forward over the unix-socket RPC to the backend:
    answers equal the in-process server's, errors are 400s validated in
    the front, /healthz rides the RPC."""
    from gdmcf_torch.serve_http import serve_multiproc

    rec, _ = server
    port = _free_port()
    backend, fronts = serve_multiproc(rec, "127.0.0.1", port, 2)
    base = f"http://127.0.0.1:{port}"
    try:
        body = _wait_up(base)
        assert body["ok"] and body["n_user"] == 40
        code, body = _get(base + "/recommend?users=0,3,7&k=5")
        assert code == 200
        np.testing.assert_array_equal(np.asarray(body["items"]),
                                      rec.recommend([0, 3, 7], k=5)[0])
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/recommend?users=999&k=5")
        assert e.value.code == 400
        for u in range(8):
            assert _get(base + f"/recommend?users={u}&k=3")[0] == 200
        assert all(p.poll() is None for p in fronts)
    finally:
        backend.close()
        _stop(fronts)


def test_multiproc_refuses_an_ephemeral_port(server):
    from gdmcf_torch.serve_http import serve_multiproc

    with pytest.raises(ValueError, match="explicit --port"):
        serve_multiproc(server[0], "127.0.0.1", 0, 2)


def test_multiproc_supervisor_respawns_dead_front(server):
    """supervise_fronts respawns a killed front (the group keeps serving)
    and, once the restart budget of its 300 s window is spent, raises."""
    from gdmcf_torch.serve_http import serve_multiproc, supervise_fronts

    rec, _ = server
    port = _free_port()
    backend, fronts = serve_multiproc(rec, "127.0.0.1", port, 2)
    base = f"http://127.0.0.1:{port}"
    stop = threading.Event()
    sup_err = []

    def run_supervisor():
        try:
            supervise_fronts(backend, fronts, "127.0.0.1", port,
                             max_restarts=1, poll_s=0.1, stop_event=stop)
        except RuntimeError as e:
            sup_err.append(e)

    t = threading.Thread(target=run_supervisor, daemon=True)
    try:
        _wait_up(base)
        t.start()
        victim = fronts[0]
        victim.kill()
        victim.wait(timeout=10)
        deadline = time.time() + 20
        while fronts[0] is victim and time.time() < deadline:
            time.sleep(0.1)
        assert fronts[0] is not victim, "supervisor never respawned"
        deadline = time.time() + 30
        ok = 0
        while time.time() < deadline and ok < 6:
            try:
                assert _get(base + f"/recommend?users={ok}&k=3")[0] == 200
                ok += 1
            except OSError:
                time.sleep(0.2)
        assert ok == 6
        assert all(p.poll() is None for p in fronts)
        # the budget (1) is spent: a second death ends the supervisor
        fronts[1].kill()
        deadline = time.time() + 20
        while not sup_err and time.time() < deadline:
            time.sleep(0.1)
        assert sup_err and "crash loop" in str(sup_err[0])
    finally:
        stop.set()
        if t.ident:
            t.join(timeout=10)
        backend.close()
        _stop(fronts)


def test_supervisor_window_forgets_old_restarts(monkeypatch):
    """The restart budget counts restarts inside a sliding 300 s window:
    crashes spread further apart never exhaust it."""
    from gdmcf_torch import serve_front
    from gdmcf_torch.serve_http import supervise_fronts

    clock = {"t": 0.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])
    monkeypatch.setattr(time, "sleep", lambda s: None)

    class Dead:
        pid = 1

        def poll(self):
            return 1

    spawned = []

    def spawn(n, *a, **kw):
        clock["t"] += 301.0   # each crash comes 301 s after the last
        spawned.append(n)
        if len(spawned) >= 5:
            stop.set()
        return [Dead()]

    monkeypatch.setattr(serve_front, "spawn_fronts", spawn)
    stop = threading.Event()
    fronts = [Dead()]
    supervise_fronts(type("B", (), {"sock_path": "x"})(), fronts,
                     "127.0.0.1", 1, max_restarts=1, poll_s=0.0,
                     stop_event=stop)
    assert len(spawned) == 5   # five restarts on a budget of one


def test_front_watchdog_exits_on_backend_death(server):
    """A front whose backend dies exits with rc 3 instead of holding the
    port; Backend.close() severs live connections, so it looks dead."""
    from gdmcf_torch.serve_front import Backend, spawn_fronts
    from gdmcf_torch.serve_http import Coalescer

    rec, _ = server
    sock_path = os.path.join(tempfile.gettempdir(),
                             f"gdmcf_wd_{uuid.uuid4().hex[:8]}.sock")
    port = _free_port()
    backend = Backend(Coalescer(rec), rec, sock_path)
    fronts = spawn_fronts(1, sock_path, "127.0.0.1", port,
                          watchdog_interval=0.2, watchdog_failures=3)
    try:
        _wait_up(f"http://127.0.0.1:{port}")
        backend.close()
        deadline = time.time() + 30
        while fronts[0].poll() is None and time.time() < deadline:
            time.sleep(0.2)
        assert fronts[0].poll() == 3, fronts[0].poll()
    finally:
        backend.close()
        _stop(fronts)


def test_multiproc_front_forwards_reload(server, tmp_path):
    """POST /reload on a front rides the RPC to the backend and swaps its
    parameters."""
    from gdmcf_torch.serve_http import serve_multiproc

    rec, _ = server
    orig = _live(rec)
    ckpt_dir, saved = _checkpoint(tmp_path, "mp_reload", 7)
    port = _free_port()
    backend, fronts = serve_multiproc(rec, "127.0.0.1", port, 1)
    base = f"http://127.0.0.1:{port}"
    try:
        _wait_up(base)
        before = _get(base + "/healthz")[1]["stats"]["params_version"]
        _, body = _post(base + "/reload",
                        json.dumps({"ckpt_dir": ckpt_dir}).encode())
        assert body["reloaded"] and body["step"] == 7
        after = _get(base + "/healthz")[1]["stats"]["params_version"]
        assert after == before + 1
        assert _equal(_live(rec), saved)
        assert _get(base + "/recommend?users=0&k=3")[0] == 200
        # a refused reload through a front is a 409 as well
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/reload",
                  json.dumps({"ckpt_dir": str(tmp_path / "nope")}).encode())
        assert e.value.code == 409
    finally:
        backend.close()
        _stop(fronts)
        rec._swap(orig)
        rec.ckpt_dir = None


def test_front_reload_with_dead_backend_is_502(server):
    """/reload over a dead RPC transport is 502 (backend unreachable), not
    the 409 of a refused swap."""
    from gdmcf_torch.serve_front import Backend, spawn_fronts
    from gdmcf_torch.serve_http import Coalescer

    rec, _ = server
    sock_path = os.path.join(tempfile.gettempdir(),
                             f"gdmcf_502_{uuid.uuid4().hex[:8]}.sock")
    port = _free_port()
    backend = Backend(Coalescer(rec), rec, sock_path)
    # a long watchdog budget: the front must still be alive for the POST
    fronts = spawn_fronts(1, sock_path, "127.0.0.1", port,
                          watchdog_interval=5.0, watchdog_failures=10)
    try:
        base = f"http://127.0.0.1:{port}"
        _wait_up(base)
        backend.close()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/reload", b"{}", timeout=60)
        assert e.value.code == 502, e.value.code
        assert "unreachable" in json.loads(e.value.read())["error"]
    finally:
        backend.close()
        _stop(fronts)


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------

def _daemon(tmp_path, port, *extra):
    generate_synthetic_dataset(str(tmp_path / "data"), n_user=40, n_item=32,
                               avg_degree=6, seed=9)
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "gdmcf_torch.serve_http", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port), "--serve_batch", "8",
         "--k_max", "5", f"--data_path={tmp_path / 'data'}",
         "--dataset=wdtest", "--dims=[16]", "--steps=5",
         "--sampling_steps=0", *extra],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def test_daemon_sigterm_tears_down_fronts(tmp_path):
    """``kill <daemon>`` unwinds (SIGTERM -> SystemExit -> finally) and
    takes its front processes down with it."""
    psutil = pytest.importorskip("psutil")
    port = _free_port()
    daemon = _daemon(tmp_path, port, "--procs", "2")
    fronts = []
    try:
        _wait_up(f"http://127.0.0.1:{port}", daemon, limit=120)
        fronts = psutil.Process(daemon.pid).children(recursive=True)
        assert len(fronts) >= 2, f"expected 2 front children, saw {fronts}"
        daemon.send_signal(signal.SIGTERM)
        daemon.wait(timeout=30)
        deadline = time.time() + 20
        alive = lambda: [p for p in fronts if p.is_running()  # noqa: E731
                         and p.status() != psutil.STATUS_ZOMBIE]
        while time.time() < deadline and alive():
            time.sleep(0.2)
        assert not alive(), f"orphaned fronts after SIGTERM: {alive()}"
    finally:
        _stop([daemon])
        for p in fronts:
            try:
                p.kill()
            except psutil.NoSuchProcess:
                pass


def test_daemon_serves_a_checkpoint_reloads_on_sighup_and_exits_on_sigterm(
        tmp_path):
    """The single-process daemon on --device cpu: serves a checkpoint,
    SIGHUP reloads it (params_version 1), SIGTERM exits 0."""
    port = _free_port()
    ckpt_dir, _ = _checkpoint(tmp_path, "daemon_ckpt", 4, shift=0.01)
    daemon = _daemon(tmp_path, port, "--ckpt_dir_serve", ckpt_dir)
    try:
        base = f"http://127.0.0.1:{port}"
        body = _wait_up(base, daemon, limit=120)
        assert body["stats"]["params_version"] == 0
        assert _get(base + "/recommend?users=1,2&k=5")[0] == 200
        daemon.send_signal(signal.SIGHUP)
        deadline = time.time() + 60
        while _get(base + "/healthz")[1]["stats"]["params_version"] != 1:
            assert time.time() < deadline, "SIGHUP never reloaded"
            time.sleep(0.2)
        daemon.send_signal(signal.SIGTERM)
        assert daemon.wait(timeout=30) == 0
        out = daemon.stdout.read()
        assert "SIGHUP reload: {'reloaded': True" in out, out
    finally:
        _stop([daemon])


# ---------------------------------------------------------------------------
# against the JAX package's server
# ---------------------------------------------------------------------------

def test_answers_equal_the_jax_server_at_equal_weights(tmp_path):
    """The JAX package's make_server and the port's, at the JAX init moved
    across by the bridge, answer the same users with the same ids."""
    import jax

    from gdmcf_torch import compat
    from gdmcf_tpu.config import Config as JConfig
    from gdmcf_tpu.serve import Recommender as JRecommender
    from gdmcf_tpu.serve_http import make_server as j_make_server
    from gdmcf_tpu.train.trainer import Trainer as JTrainer

    paths = generate_synthetic_dataset(str(tmp_path), n_user=40, n_item=32,
                                       avg_degree=6, seed=9)
    train, _, _, n_user, n_item = data_load(*paths)
    jkw = {k: v for k, v in CFG.items() if k != "device"}
    jt = JTrainer(JConfig(**jkw), n_user, n_item)
    jstate = jt.init_state()
    jrec = JRecommender.from_state(jt, jstate, train, serve_batch=8)
    sd = compat.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    trec = Recommender.from_state(Trainer(Config(**CFG), n_user, n_item),
                                  sd, train, serve_batch=8)
    servers = [j_make_server(jrec, "127.0.0.1", 0),
               make_server(trec, "127.0.0.1", 0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    try:
        bases = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
        for qs in ("users=0,3,7,11&k=10", "users=39&k=20",
                   "users=5,6&k=8&exclude_history=false",
                   "users=" + ",".join(str(u) for u in range(20)) + "&k=5"):
            want, got = (_get(b + "/recommend?" + qs)[1] for b in bases)
            assert got == want, qs
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
