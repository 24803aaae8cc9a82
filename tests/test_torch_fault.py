"""Recovery from a killed process on the port, the counterparts of
``tests/test_fault_injection.py`` and ``tests/test_multihost_fault.py``.

One process: a training child (``fit`` with ``ckpt_every`` 1) is killed
with SIGKILL at each moment that leaves a different directory behind:
before its first checkpoint commits, inside ``torch.save`` (a stub writes
half the file, then kills), after ``os.replace`` but before the deferred
``train_meta.json`` sidecar, at the top of an epoch, and from outside once
a checkpoint exists. A fresh child with ``resume`` then restores the
newest committed step, its parameters, moments, masters, Lt ring, step
and generator bitwise equal to that file, and trains on to the end; an
unfinished ``.tmp-`` file is never read, and is left in place, as the
JAX package's Orbax manager (without ``cleanup_tmp_directories``) leaves
its unfinished directories.

A mesh: (2, 2) over 4 gloo ranks (tests/torch_parallel_worker.py,
MODE=fault): the last rank kills itself at the top of epoch 3 once the
epoch-2 checkpoint has committed; every survivor exits non-zero within the
heartbeat timeout plus 15 s and prints no epoch-3 result. Then the gang
restarts (MODE=resume): every rank restores epoch 2, trains epochs 3-4 and
prints the same recall.

Tolerance: none; restored state is compared bitwise.
"""

import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
HEARTBEAT_S = 10
EPOCHS = 4

# one training process: fit over the splits in argv[1], checkpoints in
# argv[2], argv[3] epochs, a kill at argv[4] (none, write:N, sidecar:N,
# epoch:E); a resumed run checks what it restored against the file
# (tests/torch_fault_hooks.py)
CHILD = r"""
import os, sys
import torch
torch.set_num_threads(1)
from gdmcf_torch.config import Config
from gdmcf_torch.data.loader import data_load_dir
from gdmcf_torch.train import checkpoint as C
from gdmcf_torch.train.trainer import Trainer
from torch_fault_hooks import check_restores, die, hook_epochs

data_dir, ckpt_dir, epochs, kill = (sys.argv[1], sys.argv[2],
                                    int(sys.argv[3]), sys.argv[4])
what, _, n = kill.partition(":")
n = int(n or 0)
calls = {"save": 0, "commit": 0}

save = torch.save
def partial_save(obj, path):
    calls["save"] += 1
    if what == "write" and calls["save"] == n:
        import io
        buf = io.BytesIO()
        save(obj, buf)
        with open(path, "wb") as fh:   # half the file, then the kill
            fh.write(buf.getvalue()[: len(buf.getvalue()) // 2])
            fh.flush()
            os.fsync(fh.fileno())
        die(f"KILLED {kill}")
    save(obj, path)
torch.save = partial_save

write = C.Checkpointer._write
def committed(self, step, payload):
    write(self, step, payload)
    calls["commit"] += 1
    if what == "sidecar" and calls["commit"] == n:
        die(f"KILLED {kill}")   # committed; its sidecar waits for the next save
C.Checkpointer._write = committed

check_restores(lambda state, path: print("RESTORED_BITWISE", path,
                                         flush=True))

train, valid, test, n_user, n_item = data_load_dir(data_dir)
cfg = Config(device="cpu", backbone="DNNOneHotEmbeddingGCN", dims=[12],
             emb_size=10, steps=5, noise_scale=0.01, batch_size=16,
             epochs=epochs, eval_every=2, ckpt_every=1, topN=[5], lr=1e-3,
             sampling_steps=0, ckpt_dir=ckpt_dir, resume=True,
             bf16_weights=("in_layers/",))
trainer = Trainer(cfg, n_user, n_item)

def before(epoch):
    if what == "epoch" and epoch == n:
        die(f"KILLED {kill}")
hook_epochs(trainer, n_user // cfg.batch_size, before,
            lambda epoch, loss: print("EPOCH_DONE", epoch, flush=True))
state, best = trainer.fit(train, valid, test, log=print)
print("CHILD_DONE step", state.step, flush=True)
"""


def child(data_dir, ckpt_dir, epochs, kill="none", wait=True):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "tests")]), OMP_NUM_THREADS="1")
    p = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(data_dir), str(ckpt_dir),
         str(epochs), kill], env=env, cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if not wait:
        return p
    out = p.communicate(timeout=240)[0]
    return p.returncode, out


def committed(ckpt_dir):
    """{path: step} of every committed checkpoint, both streams."""
    out = {}
    for d in (Path(ckpt_dir), Path(ckpt_dir) / "periodic"):
        if d.is_dir():
            for f in d.iterdir():
                m = re.fullmatch(r"ckpt_(\d+)\.pt", f.name)
                if m:
                    out[str(f)] = int(m.group(1))
    return out


def leftovers(ckpt_dir):
    return sorted(str(f.relative_to(ckpt_dir))
                  for f in Path(ckpt_dir).rglob("*.tmp-*"))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from gdmcf_torch.data.loader import generate_synthetic_dataset

    d = tmp_path_factory.mktemp("fault_data")
    generate_synthetic_dataset(str(d) + "/", n_user=48, n_item=32,
                               avg_degree=8, seed=13)
    return d


# (the kill, whether a checkpoint has committed by then, whether an
# unfinished .tmp- file is left); 3 steps an epoch, a periodic save after
# each epoch and a best save at epochs 2 and 4
KILLS = {
    "before_first_commit": ("write:1", False, True),
    "inside_torch_save": ("write:3", True, True),
    "after_commit_before_sidecar": ("sidecar:1", True, None),
    "between_epochs": ("epoch:3", True, None),
}


@pytest.mark.parametrize("moment", list(KILLS))
def test_a_killed_fit_resumes_from_the_newest_committed_step(data_dir,
                                                             tmp_path,
                                                             moment):
    kill, any_commit, tmp_left = KILLS[moment]
    ck = tmp_path / "ck"
    rc, out = child(data_dir, ck, EPOCHS, kill)
    assert rc == -signal.SIGKILL and f"KILLED {kill}" in out, out[-3000:]
    saved = committed(ck)
    assert bool(saved) == any_commit, (saved, out[-3000:])
    if tmp_left is not None:
        assert bool(leftovers(ck)) == tmp_left, leftovers(ck)
    if moment == "after_commit_before_sidecar":
        assert not list(ck.rglob("train_meta.json"))
    left = leftovers(ck)

    rc, out = child(data_dir, ck, EPOCHS)
    assert rc == 0, out[-3000:]
    if saved:
        newest = max(saved.values())
        line = [ln for ln in out.splitlines()
                if ln.startswith("RESTORED_BITWISE")]
        assert line and saved[line[0].split()[1]] == newest, (saved, line)
        assert f"resumed from checkpoint at step {newest} " in out
        first = newest // 3 + 1
    else:
        assert "resumed from checkpoint" not in out
        first = 1
    done = [int(ln.split()[1]) for ln in out.splitlines()
            if ln.startswith("EPOCH_DONE")]
    assert done == list(range(first, EPOCHS + 1)), done
    assert f"CHILD_DONE step {EPOCHS * 3}" in out
    # the unfinished file of the killed process is left, and never read
    assert set(left) <= set(leftovers(ck))


def test_a_fit_killed_from_outside_resumes(data_dir, tmp_path):
    """The counterpart of tests/test_fault_injection.py: a long fit is
    killed once a checkpoint exists; a fresh process resumes from it."""
    ck = tmp_path / "ck"
    p = child(data_dir, ck, 500, wait=False)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and len(committed(ck)) < 2:
            time.sleep(0.05)
        assert committed(ck), "no checkpoint appeared before the kill"
    finally:
        p.kill()
        p.communicate()
    saved = committed(ck)
    rc, out = child(data_dir, ck, max(saved.values()) // 3 + 2)
    assert rc == 0, out[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESTORED_BITWISE")]
    assert line and saved[line[0].split()[1]] == max(saved.values())
    assert "CHILD_DONE" in out


def test_a_missing_sidecar_resumes_as_the_jax_package_does(tmp_path):
    """A checkpoint that committed without its sidecar: ``fit`` resumes
    with the JAX package's fallback for a missing best-metric record (no
    early stop at once; the first evaluation after it is a new best), as
    tests/test_round2_fixes.py::test_fit_resume_restores_best_metric sets
    the record up. Both packages, each evaluation of the first run a new
    best, the sidecar removed, the evaluations after the resume forced to
    one value."""
    import scipy.sparse as sp

    from gdmcf_torch.config import Config as TConfig
    from gdmcf_torch.train.checkpoint import Checkpointer as TCk
    from gdmcf_torch.train.trainer import Trainer as TTrainer
    from gdmcf_tpu.config import Config as JConfig
    from gdmcf_tpu.train.checkpoint import Checkpointer as JCk
    from gdmcf_tpu.train.trainer import Trainer as JTrainer

    rng = np.random.default_rng(0)
    n_user, n_item = 32, 24
    mats = [sp.csr_matrix((rng.random((n_user, n_item)) < p)
                          .astype(np.float32)) for p in (0.3, 0.1, 0.1)]
    metas = {}
    for name, Config, Trainer, Ck, kw in (
            ("jax", JConfig, JTrainer, JCk, {}),
            ("port", TConfig, TTrainer, TCk, {"device": "cpu"})):
        d = str(tmp_path / name)

        def cfg(epochs):
            return Config(backbone="DNNOneHotEmbeddingGCN", dims=[12],
                          emb_size=10, steps=3, noise_scale=0.01,
                          batch_size=8, topN=[5, 10], sampling_steps=0,
                          epochs=epochs, eval_every=1, ckpt_dir=d,
                          resume=True, fidelity=False, random_seed=3,
                          early_stop_patience=2, **kw)

        t = Trainer(cfg(2), n_user, n_item)
        calls = []

        def rising(*a, **k):   # each epoch's evaluation a new best
            calls.append(1)
            v = 0.1 * ((len(calls) + 1) // 2)
            return tuple([v, v] for _ in range(4))
        t.evaluate = rising
        t.fit(*mats, log=lambda *a: None)
        assert Ck(d).load_extra()["best_epoch"] == 2
        os.remove(os.path.join(d, "train_meta.json"))
        t = Trainer(cfg(4), n_user, n_item)
        t.evaluate = lambda *a, **k: tuple([0.0, 0.0] for _ in range(4))
        lines = []
        t.fit(*mats, log=lambda *a: lines.append(" ".join(map(str, a))))
        metas[name] = (Ck(d).load_extra(), lines[-1])
    assert metas["port"] == metas["jax"], metas
    assert metas["port"][0]["best_epoch"] == 3


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gang(work, mode, mesh=(2, 2), fault="kill"):
    port = _free_port()
    procs = []
    for rank in range(mesh[0] * mesh[1]):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES=str(mesh[0] * mesh[1]),
                   PROCESS_ID=str(rank), HEARTBEAT_TIMEOUT_S=str(HEARTBEAT_S),
                   MODE=mode, WORK_DIR=str(work),
                   MESH=f"{mesh[0]},{mesh[1]}", FAULT=fault,
                   PYTHONPATH=str(ROOT),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER)], env=env, cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def _wait(procs, limit):
    """(outputs, exit codes, exit times): every rank is killed past
    ``limit`` seconds, which fails the test."""
    t0, ends = time.time(), [None] * len(procs)
    while time.time() - t0 < limit and None in ends:
        for i, p in enumerate(procs):
            if ends[i] is None and p.poll() is not None:
                ends[i] = time.time()
        time.sleep(0.05)
    hung = [i for i, e in enumerate(ends) if e is None]
    for p in procs:
        if p.poll() is None:
            p.kill()
    outs = [p.communicate()[0] for p in procs]
    assert not hung, (f"ranks {hung} hung", [o[-2000:] for o in outs])
    return outs, [p.returncode for p in procs], ends


def _splits(work):
    rng = np.random.default_rng(7)
    np.savez(work / "fault.npz",
             **{k: (rng.random((32, 16)) < p).astype(np.float32)
                for k, p in (("train", 0.3), ("valid", 0.15),
                             ("test", 0.15))})


def test_a_stalled_rank_fails_the_gang_within_the_heartbeat(tmp_path):
    """A rank that stops without dying keeps its sockets open: only the
    collectives' timeout (HEARTBEAT_TIMEOUT_S, on the mesh's dp and mp
    groups too) ends its peers' wait."""
    _splits(tmp_path)
    procs = _gang(tmp_path, "fault", fault="stall")
    victim = procs[-1]
    try:
        outs, rcs, ends = _wait(procs[:-1], 120)
    finally:
        victim.kill()
    out = victim.communicate()[0]
    stopped = float(re.search(r"FAULT_SELF_STOP .* t=([\d.]+)",
                              out).group(1))
    for r, (rc, o) in enumerate(zip(rcs, outs)):
        assert rc not in (0, None), (r, rc, o[-2000:])
        assert f"EPOCH_DONE rank={r} epoch=3" not in o
        assert ends[r] - stopped <= HEARTBEAT_S + 15.0, (r, ends[r] - stopped)


def test_a_killed_rank_fails_the_gang_and_a_restart_resumes(tmp_path):
    _splits(tmp_path)
    outs, rcs, ends = _wait(_gang(tmp_path, "fault"), 180)
    victim = len(outs) - 1
    assert rcs[victim] == -signal.SIGKILL, (rcs, outs[victim][-2000:])
    assert "FAULT_SELF_KILL rank=3 epoch=3" in outs[victim]
    assert "EPOCH_DONE rank=3 epoch=2" in outs[victim]
    died = float(re.search(r"FAULT_SELF_KILL .* t=([\d.]+)",
                           outs[victim]).group(1))
    for r in range(victim):
        assert rcs[r] not in (0, None), (r, rcs[r], outs[r][-2000:])
        assert f"SURVIVOR_ENTERING rank={r} epoch=3" in outs[r]
        assert f"EPOCH_DONE rank={r} epoch=3" not in outs[r], outs[r]
        assert "WORKER_OK" not in outs[r]
        assert ends[r] - died <= HEARTBEAT_S + 15.0, (r, ends[r] - died)

    outs, rcs, _ = _wait(_gang(tmp_path, "resume"), 180)
    recalls = set()
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, (r, out[-3000:])
        assert f"RESTORED rank={r} step=8 epoch=2" in out, out[-2000:]
        assert f"EPOCH_DONE rank={r} epoch=3" in out
        assert f"EPOCH_DONE rank={r} epoch=4" in out
        assert f"EPOCH_DONE rank={r} epoch=2" not in out
        m = re.search(rf"WORKER_OK rank={r} mode=resume step=16 "
                      rf"recall=(\[.*?\])", out)
        assert m, out[-2000:]
        recalls.add(m.group(1))
    assert len(recalls) == 1, recalls
