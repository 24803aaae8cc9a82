"""The kill-and-check instrumentation of the port's recovery tests, shared
by the training child of tests/test_torch_fault.py and the ranks of
tests/torch_parallel_worker.py (MODE=fault / MODE=resume).

- ``check_restores(report)``: every ``Checkpointer.restore`` is held
  bitwise against the file it read (a rank's sharded tensors against its
  block of the file's whole tensor), then ``report(state, path)`` runs;
- ``hook_epochs(trainer, steps, before, after)``: ``before(epoch)`` runs at
  the top of each epoch of ``fit`` and ``after(epoch, loss)`` once it has
  trained, with a finite loss;
- ``die(line)``: print the line, then SIGKILL this process (or SIGSTOP it,
  a process alive but silent, with ``stop=True``);
- ``wait_for(path)``: wait until a file exists (a checkpoint the main rank
  commits in the background).

Imports torch and the port only.
"""

import math
import os
import signal
import time

import torch

from gdmcf_torch.parallel.sharding import local_block, shard_of
from gdmcf_torch.train import checkpoint as C


def check_restores(report):
    restore = C.Checkpointer.restore

    def checked(self, template, step=None):
        out = restore(self, template, step)
        path = self._path(out.step)
        data = torch.load(path, map_location="cpu", weights_only=True)
        opt = out.opt_state
        for key, live in (("params", out.params), ("mu", opt.mu),
                          ("nu", opt.nu), ("master", opt.master or {})):
            for name, t in live.items():
                want = data[key][name]
                shard = shard_of(out.params[name])
                if shard is not None:
                    want = local_block(want, shard)
                assert torch.equal(t.detach().cpu(), want), (key, name)
        for name, got in (("count", opt.count),
                          ("lt_history", out.lt.history),
                          ("lt_count", out.lt.count),
                          ("generator", out.generator.get_state())):
            assert torch.equal(got.cpu(), data[name]), name
        assert out.step == int(data["step"]), (out.step, data["step"])
        report(out, path)
        return out
    C.Checkpointer.restore = checked


def hook_epochs(trainer, steps, before=None, after=None):
    """``steps``: the steps of one of ``fit``'s epochs."""
    train_epoch = trainer.train_epoch

    def epoch_hook(state, dataset, rng):
        epoch = state.step // steps + 1
        if before is not None:
            before(epoch)
        state, loss = train_epoch(state, dataset, rng)
        assert math.isfinite(loss), loss
        if after is not None:
            after(epoch, loss)
        return state, loss
    trainer.train_epoch = epoch_hook


def die(line, stop=False):
    print(line, flush=True)
    os.kill(os.getpid(), signal.SIGSTOP if stop else signal.SIGKILL)


def wait_for(path, limit=60.0):
    deadline = time.time() + limit
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.05)
