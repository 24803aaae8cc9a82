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

``serve_http`` puts an HTTP server and a request coalescer in front of it.
"""

from __future__ import annotations

import os
import threading
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from gdmcf_torch.data.native import NativeCSR
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
        self._lock = threading.Lock()
        # hot reload: the directory to refresh from (set by from_checkpoint),
        # a version counter surfaced in /healthz, a lock serializing reloads
        self.ckpt_dir: Optional[str] = None
        self.params_version = 0
        self._reload_lock = threading.Lock()

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_dir: str, train_csr,
                        serve_batch: int = 256, k_max: int = 100,
                        device=None) -> "Recommender":
        """A new Trainer whose parameters are those of the newest checkpoint
        in ``ckpt_dir`` (``train/checkpoint.py``); the optimizer state is
        neither built nor read. The Trainer stores its parameters as
        ``cfg`` says (``param_dtype``, ``bf16_weights``), and the
        checkpoint's must be stored alike."""
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
        trainer's own parameters)."""
        if state is not None:
            trainer.model.load_state_dict(
                {k: v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v))
                 for k, v in state.items()})
        # membership semantics: the history is which items to exclude
        return cls(trainer, NativeCSR.from_scipy(train_csr, strict=False),
                   serve_batch, k_max)

    def _load_params(self, directory: str, step: Optional[int]):
        """(step, {name: device tensor}) of a checkpoint's parameters,
        checked name by name against the live ones for shape and dtype.
        Reads only the parameters (no moments) and allocates one parameter
        set on the device; runs off the dispatch lock."""
        from gdmcf_torch.train.checkpoint import Checkpointer

        if not os.path.isdir(directory):
            raise FileNotFoundError(
                f"checkpoint directory {directory!r} does not exist")
        saved_step, saved = Checkpointer(directory).load_params(step)
        live = dict(self.trainer.model.named_parameters())
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

    def _swap(self, new: Mapping[str, torch.Tensor]) -> None:
        """Point every parameter at its new tensor, between two dispatches
        (under the dispatch lock): a dispatch launches all its kernels
        under that lock, so it reads one set whole, old or new."""
        with self._lock, torch.no_grad():
            for name, p in self.trainer.model.named_parameters():
                p.data = new[name]

    def reload_params(self, ckpt_dir: Optional[str] = None,
                      step: Optional[int] = None) -> dict:
        """Swap in the parameters of a checkpoint (the newest in
        ``ckpt_dir``, default the directory this recommender was loaded
        from, or ``step``) with no dropped request. The checkpoint is read
        and copied to the device off the dispatch lock; the swap itself
        waits only for the dispatch in flight. Raises on a missing or
        mismatched checkpoint (other names, shapes or dtypes), leaving the
        live parameters untouched. Buffers derived from the graph (the
        lightGCN backbone's tables) are not in a checkpoint and stay."""
        directory = ckpt_dir or self.ckpt_dir
        if not directory:
            raise ValueError(
                "no checkpoint directory: this recommender was built from a "
                "live state (demo mode); pass ckpt_dir explicitly")
        with self._reload_lock:
            loaded_step, new = self._load_params(directory, step)
            self._swap(new)
            del new
            self.params_version += 1
            self.ckpt_dir = directory
            return {"reloaded": True, "ckpt_dir": directory,
                    "step": loaded_step,
                    "params_version": self.params_version}

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

    def recommend_batch(self, user_ids: Sequence[int],
                        exclude_rows: np.ndarray) -> np.ndarray:
        """ONE padded dispatch for up to ``serve_batch`` users with a
        per-row exclude decision; returns [n, k_max] score-sorted ids. The
        primitive request coalescing builds on: rows with different
        ``exclude_history`` and ``k`` share a dispatch."""
        cfg = self.trainer.cfg
        user_ids = np.asarray(user_ids, dtype=np.int64)
        if not 0 < user_ids.size <= self.serve_batch:
            raise ValueError(f"recommend_batch takes 1..{self.serve_batch} "
                             f"users; got {user_ids.size}")
        pad = self.serve_batch - user_ids.size
        padded = np.concatenate([user_ids, np.zeros(pad, np.int64)])
        rows = (self.history.gather_packed(padded)
                if cfg.wire_format == "packed"
                else self.history.gather(padded))
        excl = np.concatenate([np.asarray(exclude_rows, dtype=bool),
                               np.zeros(pad, dtype=bool)])
        mask = np.where(excl[:, None], rows, np.zeros_like(rows))
        dev = self.trainer.device
        with self._lock:
            idx = self.trainer.eval_step(
                torch.from_numpy(rows).to(dev),
                torch.from_numpy(padded).to(dev),
                torch.from_numpy(mask).to(dev),
                sampling_steps=cfg.sampling_steps, top_k=self.k_max,
                generator=self._generator)
        return idx.cpu().numpy()[: user_ids.size]


def build_recommender(cfg, ckpt_dir, train_csr, n_user: int, n_item: int,
                      warmup: bool = True, device=None,
                      trainer: Optional[Trainer] = None,
                      **kw) -> Recommender:
    """Build the recommender and warm up: from the newest checkpoint in
    ``ckpt_dir``, over ``trainer`` (a trained Trainer, its parameters as
    they are) or, without either, a new Trainer (demo mode: fresh init)."""
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
        print(f"loaded checkpoint from {ckpt_dir}")
    else:
        if trainer is None:
            trainer = Trainer(cfg, n_user, n_item, train_csr=train_csr,
                              device=device)
            print("no checkpoint; serving from fresh init (demo mode)")
        rec = Recommender.from_state(trainer, None, train_csr, **kw)
    if warmup:
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
    users = [int(u) for u in ns.users.split(",")]
    t0 = time.perf_counter()
    items, uids = rec.recommend(users, k=ns.k)
    dt = (time.perf_counter() - t0) * 1000
    for u, row in zip(uids, items):
        print(f"user {u}: top-{ns.k} -> {row.tolist()}")
    print(f"latency: {dt:.1f} ms for {len(users)} users on {rec.trainer.device}")


if __name__ == "__main__":
    main()
