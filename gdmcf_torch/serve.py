"""Serving: a recommender that answers user queries in fixed-shape batches.

Port of the JAX package's ``serve.py``: requests of any size are padded into
``serve_batch`` rows per dispatch; each dispatch ranks ``k_max`` items and
any ``k <= k_max`` is a prefix of that ranking.

    python -m gdmcf_torch.serve -c configs/amazonOneEmbGcn.yaml \\
        --device cuda --data_path ./Datasets/amazon-book_clean/

serves the recipe's backbone (the flagship ``DNNOneHotEmbeddingGCN``;
``--backbone`` takes any name of ``models.registry.BACKBONES``; a
OneHotMatrix 1 model serves at ``--serve_batch`` equal to its
``batch_size``) from the newest checkpoint of
``--ckpt_dir_serve`` (or ``--ckpt_dir``), as ``fit`` writes them. Without
either the recommender serves a fresh init (demo mode) or, from Python, a
trained ``Trainer`` (``build_recommender(..., trainer=t)``):

    rec = Recommender.from_checkpoint(cfg, ckpt_dir, train_csr)
    items, uids = rec.recommend([3, 17, 42], k=20)
    rec.reload_params()       # hot swap to the newest checkpoint of ckpt_dir

On a (dp, mp) mesh (``--mesh_dp``/``--mesh_mp``, one process per rank under
the env contract of ``parallel.multihost.initialize``, which
``build_recommender`` calls) every rank builds the same recommender over
its blocks of the parameters. The main rank (rank 0) takes the requests:
each dispatch, reload, heartbeat and stop goes to the other ranks over the
dispatch channel (``parallel/channel.py``) and then runs on every rank,
its rows sharded over dp as ``Trainer.evaluate`` shards them; the other
ranks run ``Recommender.follow`` until the main rank stops them. Only the
main rank prints.

``serve_http`` puts an HTTP server and a request coalescer in front of it.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from gdmcf_torch.data.native import NativeCSR
from gdmcf_torch.parallel import channel as ch
from gdmcf_torch.train.trainer import Trainer


class Recommender:
    def __init__(self, trainer: Trainer, history: NativeCSR,
                 serve_batch: int = 256, k_max: int = 100):
        if trainer.cfg.OneHotMatrix == 1 and serve_batch != \
                trainer.cfg.batch_size:
            # the block-one-hot model's input width is n_item + batch_size
            raise ValueError(
                f"OneHotMatrix=1 models serve only at serve_batch = "
                f"batch_size ({trainer.cfg.batch_size}); got {serve_batch}")
        self.trainer = trainer
        self.history = history
        self.serve_batch = serve_batch
        self.k_max = min(k_max, history.n_item)
        self._generator = torch.Generator(trainer.device).manual_seed(
            trainer.cfg.random_seed + 777)
        # held around each dispatch's launches and around a reload's swap
        # (on a mesh around each op, its channel send included)
        self._lock = threading.Lock()
        # hot reload: the directory to refresh from (set by from_checkpoint),
        # a version counter surfaced in /healthz, a lock serializing reloads
        self.ckpt_dir: Optional[str] = None
        self.params_version = 0
        self._reload_lock = threading.Lock()
        # on a mesh: the dispatch channel (rank 0 sends, the others follow)
        self.channel = (ch.Channel(serve_batch)
                        if trainer.mesh is not None else None)
        # runs a function in dispatch order on the thread that makes every
        # launch (``serve_http.Coalescer`` sets it); None: the caller's
        self.ordered: Optional[Callable] = None
        self.stopped = False

    @property
    def is_main(self) -> bool:
        """True on a single process and on a mesh's main rank, the one
        that takes requests."""
        return self.channel is None or self.channel.is_source

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_dir: str, train_csr,
                        serve_batch: int = 256, k_max: int = 100,
                        device=None) -> "Recommender":
        """A new Trainer whose parameters are those of the newest checkpoint
        in ``ckpt_dir`` (``train/checkpoint.py``); the optimizer state is
        neither built nor read. The Trainer stores its parameters as
        ``cfg`` says (``param_dtype``, ``bf16_weights``), and the
        checkpoint's must be stored alike. On a mesh each rank reads its
        blocks."""
        # membership semantics: the history is which items to exclude
        history = NativeCSR.from_scipy(train_csr, strict=False)
        trainer = Trainer(cfg, history.n_user, history.n_item,
                          train_csr=train_csr, device=device)
        rec = cls(trainer, history, serve_batch, k_max)
        rec._swap(rec._load_params(ckpt_dir, None)[1])
        rec.ckpt_dir = ckpt_dir
        return rec

    @classmethod
    def from_state(cls, trainer: Trainer,
                   state: Optional[Mapping[str, torch.Tensor]], train_csr,
                   serve_batch: int = 256, k_max: int = 100
                   ) -> "Recommender":
        """``state``: a state_dict for ``trainer.model`` (None keeps the
        trainer's own parameters), whole tensors: on a mesh each rank keeps
        its blocks."""
        if state is not None:
            from gdmcf_torch.parallel.sharding import local_block, shard_of

            live = trainer.model.state_dict(keep_vars=True)
            own = {}
            for k, v in state.items():
                t = (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(v)))
                shard = shard_of(live[k]) if k in live else None
                own[k] = t if shard is None else local_block(t, shard)
            trainer.model.load_state_dict(own)
        # membership semantics: the history is which items to exclude
        return cls(trainer, NativeCSR.from_scipy(train_csr, strict=False),
                   serve_batch, k_max)

    def _load_params(self, directory: str, step: Optional[int]):
        """(step, {name: device tensor}) of a checkpoint's parameters,
        checked name by name against the live ones for shape and dtype (on
        a mesh: this rank's blocks against its live blocks). Reads only the
        parameters (no moments) and allocates one parameter set (one set
        of blocks) on the device; runs off the dispatch lock on one
        device."""
        from gdmcf_torch.parallel.sharding import shard_of
        from gdmcf_torch.train.checkpoint import Checkpointer

        if not os.path.isdir(directory):
            raise FileNotFoundError(
                f"checkpoint directory {directory!r} does not exist")
        live = dict(self.trainer.model.named_parameters())
        saved_step, saved = Checkpointer(directory).load_params(
            step, {k: shard_of(p) for k, p in live.items()})
        if set(saved) != set(live):
            raise ValueError(
                f"checkpoint at {directory} names parameters "
                f"{sorted(set(saved) ^ set(live))} that the serving model "
                "does or does not have: it was trained under another config")
        for name, p in live.items():
            t = saved[name]
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(
                    f"checkpoint at {directory} has {name} {t.dtype} "
                    f"{tuple(t.shape)}, the serving model {p.dtype} "
                    f"{tuple(p.shape)}: it was trained under another "
                    "geometry or config and cannot be swapped in")
        new = {k: saved[k].to(live[k].device, copy=True) for k in live}
        if self.trainer.device.type == "cuda":
            # the copies ran on this thread's stream; a dispatch may run on
            # another, so they must be done before the swap
            torch.cuda.current_stream(self.trainer.device).synchronize()
        return saved_step, new

    def _assign(self, new: Mapping[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for name, p in self.trainer.model.named_parameters():
                p.data = new[name]

    def _swap(self, new: Mapping[str, torch.Tensor]) -> None:
        """Point every parameter at its new tensor, between two dispatches
        (under the dispatch lock): a dispatch launches all its kernels
        under that lock, so it reads one set whole, old or new."""
        with self._lock:
            self._assign(new)

    def _in_order(self, fn: Callable):
        return fn() if self.ordered is None else self.ordered(fn)

    def reload_params(self, ckpt_dir: Optional[str] = None,
                      step: Optional[int] = None) -> dict:
        """Swap in the parameters of a checkpoint (the newest in
        ``ckpt_dir``, default the directory this recommender was loaded
        from, or ``step``) with no dropped request. The checkpoint is read
        and copied to the device off the dispatch lock; the swap itself
        waits only for the dispatch in flight. Raises on a missing or
        mismatched checkpoint (other names, shapes or dtypes), leaving the
        live parameters untouched. Buffers derived from the graph (the
        lightGCN backbone's tables) are not in a checkpoint and stay.

        On a mesh the main rank sends a ``reload`` op, ordered with the
        dispatches, and every rank reads its blocks, agrees that all
        ranks read theirs, and swaps between the same two dispatches (no
        rank swaps when one of them could not read)."""
        directory = ckpt_dir or self.ckpt_dir
        if not directory:
            raise ValueError(
                "no checkpoint directory: this recommender was built from a "
                "live state (demo mode); pass ckpt_dir explicitly")
        if self.channel is not None:
            op = ch.Op(ch.RELOAD, step=step,
                       directory=os.path.abspath(directory))
            return self._in_order(lambda: self._send(op))
        with self._reload_lock:
            loaded_step, new = self._load_params(directory, step)
            self._swap(new)
            del new
            return self._reloaded(directory, loaded_step)

    def _reloaded(self, directory: str, step: int) -> dict:
        self.params_version += 1
        self.ckpt_dir = directory
        return {"reloaded": True, "ckpt_dir": directory, "step": step,
                "params_version": self.params_version}

    def _reload_on_mesh(self, directory: str, step: Optional[int]) -> dict:
        """Every rank, under the dispatch lock: read this rank's blocks,
        agree over the world, swap (collective)."""
        try:
            loaded_step, new, err = *self._load_params(directory, step), None
        except Exception as e:   # reported after the agreement
            loaded_step, new, err = None, None, e
        if not self.channel.agree(err is None):
            raise err or RuntimeError(
                f"another rank could not read the checkpoint at {directory}"
                ": no rank swapped, the old parameters keep serving")
        self._assign(new)
        del new
        return self._reloaded(directory, loaded_step)

    def warmup(self) -> None:
        self.recommend(list(range(min(2, self.history.n_user))),
                       k=min(10, self.k_max))

    def recommend(self, user_ids: Sequence[int], k: int = 20,
                  exclude_history: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k item ids for the users; returns ([n, k] items, [n] ids)."""
        if not 1 <= k <= self.k_max:
            raise ValueError(f"k={k} outside [1, k_max={self.k_max}]")
        user_ids = np.asarray(user_ids, dtype=np.int64)
        n_user = len(self.history)
        if user_ids.size == 0:
            raise ValueError("recommend() needs at least one user id")
        if user_ids.min() < 0 or user_ids.max() >= n_user:
            raise ValueError(f"user ids must be in [0, {n_user}); got "
                             f"min={user_ids.min()} max={user_ids.max()}")
        results = []
        for start in range(0, len(user_ids), self.serve_batch):
            chunk = user_ids[start:start + self.serve_batch]
            ranked = self.recommend_batch(
                chunk, np.full(len(chunk), exclude_history, dtype=bool))
            results.append(ranked[:, :k])
        return np.concatenate(results, axis=0), user_ids

    def _rows(self, ids: np.ndarray, excl: np.ndarray):
        """The history rows of ``ids`` (bit-packed under the packed wire
        format) and their exclusion mask (zeroed rows exclude nothing)."""
        rows = (self.history.gather_packed(ids)
                if self.trainer.cfg.wire_format == "packed"
                else self.history.gather(ids))
        return rows, np.where(excl[:, None], rows, np.zeros_like(rows))

    def _eval(self, rows, ids, mask, block=None) -> torch.Tensor:
        cfg, dev = self.trainer.cfg, self.trainer.device
        return self.trainer.eval_step(
            torch.from_numpy(rows).to(dev), torch.from_numpy(ids).to(dev),
            torch.from_numpy(mask).to(dev),
            sampling_steps=cfg.sampling_steps, top_k=self.k_max,
            generator=self._generator, block=block)

    def recommend_batch(self, user_ids: Sequence[int],
                        exclude_rows: np.ndarray) -> np.ndarray:
        """ONE padded dispatch for up to ``serve_batch`` users with a
        per-row exclude decision; returns [n, k_max] score-sorted ids. The
        primitive request coalescing builds on: rows with different
        ``exclude_history`` and ``k`` share a dispatch. On a mesh, the main
        rank's call runs the dispatch on every rank."""
        user_ids = np.asarray(user_ids, dtype=np.int64)
        if not 0 < user_ids.size <= self.serve_batch:
            raise ValueError(f"recommend_batch takes 1..{self.serve_batch} "
                             f"users; got {user_ids.size}")
        pad = self.serve_batch - user_ids.size
        padded = np.concatenate([user_ids, np.zeros(pad, np.int64)])
        excl = np.concatenate([np.asarray(exclude_rows, dtype=bool),
                               np.zeros(pad, dtype=bool)])
        if self.channel is not None:
            return self._send(ch.Op(ch.DISPATCH, user_ids.size, ids=padded,
                                    exclude=excl))
        rows, mask = self._rows(padded, excl)
        with self._lock:
            idx = self._eval(rows, padded, mask)
        return idx.cpu().numpy()[: user_ids.size]

    # -- the mesh: the main rank sends, every rank runs ----------------------
    def _send(self, op: ch.Op):
        """The main rank: send ``op`` on the channel and run it here, under
        the dispatch lock (the channel's order is the lock's)."""
        if not self.is_main:
            raise RuntimeError(
                "a follower rank serves through follow(); requests, reloads "
                "and stops go to the main rank (rank 0)")
        with self._lock:
            if self.stopped:
                raise RuntimeError("this mesh recommender was stopped")
            self.channel.send(op)
            return self._run(op)

    def _run(self, op: ch.Op):
        """Run one channel op on this rank (every rank runs each op)."""
        if op.code == ch.DISPATCH:
            return self._dispatch(op.ids, op.exclude, op.rows)
        if op.code == ch.RELOAD:
            return self._reload_on_mesh(op.directory, op.step)
        if op.code == ch.STOP:
            self.stopped = True
            self.channel.agree(True)   # every rank has seen the stop
        return None

    def _dispatch(self, padded: np.ndarray, excl: np.ndarray,
                  n: int) -> np.ndarray:
        """One dispatch on this rank: its dp block of the padded rows when
        dp divides ``serve_batch`` (the whole batch's draws from the
        generator every rank advances alike, cut to the block), every row
        otherwise; the ids of the whole batch come back from the dp
        group."""
        t = self.trainer
        block = (t.row_block(self.serve_batch // t._dp())
                 if t._eval_shardable(self.serve_batch) else None)
        lo, hi = (0, self.serve_batch) if block is None else (block.lo,
                                                              block.hi)
        rows, mask = self._rows(padded[lo:hi], excl[lo:hi])
        idx = self._eval(rows, padded[lo:hi], mask, block)
        if block is not None:
            from gdmcf_torch.parallel.collectives import all_gather_list

            idx = torch.cat(all_gather_list(idx, block.group))
        return idx.cpu().numpy()[:n]

    def heartbeat(self) -> None:
        """The main rank of an idle mesh: an op that keeps the followers'
        wait inside the process group's timeout. Draws nothing."""
        if self.channel is not None:
            self._in_order(lambda: self._send(ch.Op(ch.HEARTBEAT)))

    def heartbeat_s(self) -> Optional[float]:
        """Seconds an idle main rank may wait before its next heartbeat
        (a quarter of the process group's timeout); None off a mesh."""
        if self.channel is None:
            return None
        from gdmcf_torch.parallel.multihost import collective_timeout_s

        return collective_timeout_s() / 4.0

    def stop(self) -> None:
        """The main rank: every rank leaves its loop (a no-op on one
        process, and once stopped)."""
        if self.channel is not None and not self.stopped:
            self._in_order(lambda: self._send(ch.Op(ch.STOP)))

    def follow(self) -> None:
        """A follower rank: run the main rank's ops in its order until it
        sends ``stop``. A reload that no rank could swap is reported and
        the loop goes on with the old parameters; any other failure raises.
        The wait for an op raises once the process group's timeout passes
        (the main rank's heartbeats keep an idle server inside it) or when
        the main rank is gone, so a follower never serves alone."""
        if self.is_main:
            raise RuntimeError("the main rank takes requests; follow() is "
                               "the other ranks' loop")
        while not self.stopped:
            op = self.channel.recv()
            with self._lock:
                try:
                    self._run(op)
                except Exception as e:
                    if op.code != ch.RELOAD:
                        raise
                    print(f"rank reload refused (old parameters stay): "
                          f"{type(e).__name__}: {e}", flush=True)


def build_recommender(cfg, ckpt_dir, train_csr, n_user: int, n_item: int,
                      warmup: bool = True, device=None,
                      trainer: Optional[Trainer] = None,
                      **kw) -> Recommender:
    """Build the recommender and warm up: from the newest checkpoint in
    ``ckpt_dir``, over ``trainer`` (a trained Trainer, its parameters as
    they are) or, without either, a new Trainer (demo mode: fresh init).
    Starts the process group first when the env contract of
    ``multihost.initialize`` is set and none is running; on a mesh only
    the main rank warms up (the others take its warm-up dispatch in
    ``follow``) and prints."""
    import torch.distributed as dist

    from gdmcf_torch.parallel import multihost

    if not dist.is_initialized():
        multihost.initialize(device=cfg.device if device is None else device)
    say = print if multihost.is_main_process() else (lambda *a: None)
    if ckpt_dir:
        # an EXPLICIT checkpoint dir that does not exist is an operator
        # error (a typo, an unmounted volume): refuse rather than serve a
        # fresh init to live traffic; demo mode is only for no dir at all
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(
                f"--ckpt_dir_serve {ckpt_dir!r} does not exist or is not "
                "a directory; omit the flag for fresh-init demo mode")
        rec = Recommender.from_checkpoint(cfg, ckpt_dir, train_csr,
                                          device=device, **kw)
        say(f"loaded checkpoint from {ckpt_dir}")
    else:
        if trainer is None:
            trainer = Trainer(cfg, n_user, n_item, train_csr=train_csr,
                              device=device)
            say("no checkpoint; serving from fresh init (demo mode)")
        rec = Recommender.from_state(trainer, None, train_csr, **kw)
    if warmup and rec.is_main:
        rec.warmup()
    return rec


def main(argv=None):
    import argparse
    import sys
    import time

    from gdmcf_torch.config import parse_args
    from gdmcf_torch.data.loader import data_load_dir

    args = argv if argv is not None else sys.argv[1:]
    serve_flags = argparse.ArgumentParser(add_help=False)
    serve_flags.add_argument("--ckpt_dir_serve", default=None)
    serve_flags.add_argument("--k", type=int, default=20)
    serve_flags.add_argument("--users", type=str, default="0,1,2,3")
    serve_flags.add_argument("--serve_batch", type=int, default=256)
    serve_flags.add_argument("--k_max", type=int, default=100)
    ns, rest = serve_flags.parse_known_args(args)
    cfg = parse_args(rest)

    train, _valid, _test, n_user, n_item = data_load_dir(cfg.data_path)
    rec = build_recommender(cfg, ns.ckpt_dir_serve or cfg.ckpt_dir, train,
                            n_user, n_item, serve_batch=ns.serve_batch,
                            k_max=ns.k_max)
    from gdmcf_torch.parallel.multihost import shutdown

    if not rec.is_main:   # a mesh rank: the main rank's dispatches
        rec.follow()
        shutdown()
        return
    users = [int(u) for u in ns.users.split(",")]
    t0 = time.perf_counter()
    items, uids = rec.recommend(users, k=ns.k)
    dt = (time.perf_counter() - t0) * 1000
    rec.stop()
    shutdown()
    for u, row in zip(uids, items):
        print(f"user {u}: top-{ns.k} -> {row.tolist()}")
    print(f"latency: {dt:.1f} ms for {len(users)} users on {rec.trainer.device}")


if __name__ == "__main__":
    main()
