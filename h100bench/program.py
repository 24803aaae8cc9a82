"""Building the program under test for a cell: its data, the port's Trainer
with the seed's weights, and letting go of it before the reference runs.

The port (``gdmcf_torch``) is imported here and in the drivers only; the
reference imports nothing of it.
"""

from __future__ import annotations

import gc

import numpy as np


def build(ctx):
    """(trainer, train CSR, Config) of the cell's configuration, the
    weights drawn from ``ctx.seed`` into the model's own parameters."""
    conf, clock = ctx.cell.config, ctx.clock
    with clock.phase("imports"):
        from gdmcf_torch.config import Config
        from gdmcf_torch.train.trainer import Trainer
        from h100bench import data as D
        from h100bench.reference import flagship as R
    with clock.phase("data"):
        csr = D.graph(conf["graph"], conf["n_user"], conf["n_item"], ctx.seed)
    with clock.phase("trainer (the port's own init)"):
        cfg = Config(**dict(conf["recipe"], device=ctx.device))
        trainer = Trainer(cfg, conf["n_user"], conf["n_item"],
                          device=ctx.device)
    with clock.phase("weights from the seed"):
        shapes = R.param_shapes(conf["n_user"], conf["n_item"],
                                cfg.dims[-1], cfg.emb_size)
        params = dict(trainer.model.named_parameters())
        if {k: tuple(p.shape) for k, p in params.items()} != shapes:
            raise RuntimeError("the port's parameters are not the "
                               "reference's flagship")
        for k, p in params.items():
            R.fill_leaf(p.data, ctx.seed, k)
        sync(trainer.device)
    return trainer, csr, cfg


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def release(device) -> None:
    """Give the card's memory back once the caller has dropped the
    program's objects."""
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, epoch])
