"""CUDA graphs of the Trainer's fused calls: K train steps and K eval batches.

The counterpart of the JAX package's ``Trainer._train_multi`` and
``Trainer._eval_multi`` (``train/trainer.py``): one compiled program over
K stacked batches, a ``lax.scan``. PyTorch's counterpart of one program
over K steps is a CUDA graph. The K steps are captured once, over static
input buffers ([K, ...] batches, a [K] lr vector) and outputs ([K] losses,
[K, B, top_k] ids); each later group of the same shape copies its batches
in with one host->device copy (or device copies from ``evaluate``'s cache)
and replays the graph.

How a group goes (``TrainerGraphs.train`` and ``TrainerGraphs.eval``):

- A group runs eagerly when no graph of its shape is bound: the first
  train group of a shape, the first after the state's tensors changed (a
  new ``init_state``), the first group of an evaluation shape and the
  first with another eval generator: real steps, which also warm Triton's
  compile, cuBLAS's handles and the allocator. The graph is captured right
  after that group (once for a Trainer's state, in its first epoch).
  Capture runs no kernel, so the state stays that of the eager steps.
  Every later group of the shape replays, the first group of a later epoch
  too: an eager group beside the graphs' pool would need a second set of a
  step's gradients and activations (at the 1M-item catalog, dims [500],
  the second epoch ran out of the card's memory that way).
- The train state is the graph's carry: the parameters, the moments, the
  masters, K1's step count and the Lt ring are read and written in place,
  the very tensors the ``TrainState`` holds (``Trainer._update`` copies
  into them). A replay checks that the state still holds them.
- Randomness: the step generator (``state.generator``) and the eval
  generator are registered with their graphs
  (``CUDAGraph.register_generator_state``). A replay draws what the eager
  steps would draw from the generator's offset at the replay, and leaves
  the generator where they would leave it (a checkpoint saves it).
- Launch counts: K1's wrapper counts a call under capture in
  ``fused_adamw.CAPTURED``; each replay adds its graph's captured launches
  to ``fused_adamw.LAUNCHES`` (``add_replays``).
- Memory: the graphs of one Trainer share one private memory pool, which
  holds the intermediates of one group for as long as the Trainer lives.
  So a graph's outputs are good until the next replay of any graph of the
  Trainer: each replay's losses are cloned, and its ids consumed, first.

No fallback: a capture or a replay that fails raises. On the CPU there are
no graphs; the Trainer runs a group's steps one after another.

Spans (``utils.profiling.span``), on the host around each part of a group:
``gdmcf.graphs.{train,eval}.feed`` (the copies into the static buffers),
``.replay`` (the launch, and a train group's clone of its losses),
``.eager`` (the group run before a capture) and ``.capture``. None is
inside a captured body: a replay runs no host code.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from gdmcf_torch.ops import fused_adamw as FA
from gdmcf_torch.utils.profiling import span

Batches = Union[np.ndarray, Sequence[torch.Tensor]]


def _pinned(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory()


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


def _feed(buf: torch.Tensor, items: Batches) -> None:
    """Copy a group into a static [K, ...] buffer: one non-blocking copy
    of stacked host arrays through pinned memory, or one device copy per
    device tensor."""
    if isinstance(items, np.ndarray):
        buf.copy_(_pinned(items), non_blocking=True)
    else:
        for j, t in enumerate(items):
            buf[j].copy_(t)


def _carry(state) -> List[torch.Tensor]:
    """The tensors a train graph reads and writes in place."""
    opt = state.opt_state
    return [*state.params.values(), *opt.mu.values(), *opt.nu.values(),
            *(opt.master or {}).values(), opt.count, state.lt.history,
            state.lt.count]


class _Captured:
    """A captured graph, the K1 launches it recorded and its capture's
    seconds (synchronised: the capture's own work, not a queue)."""

    def __init__(self, generator: torch.Generator, pool, body):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        self.generator = generator
        before = dict(FA.CAPTURED)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = body()
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.launches = {n: FA.CAPTURED[n] - before[n] for n in before}
        self.replays = 0

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        FA.add_replays(self.launches)
        self.replays += 1
        return self.out


class TrainGraph(_Captured):
    """K train steps (``Trainer.steps_body``) over static [K, B, W]
    batches, [K, B] ids and a [K] lr vector; out: the losses [K]."""

    def __init__(self, trainer, state, xs: np.ndarray, idxs: np.ndarray,
                 pool):
        dev = trainer.device
        self.k = xs.shape[0]
        self.xs = torch.empty(xs.shape, dtype=_torch_dtype(xs), device=dev)
        self.idxs = torch.empty(idxs.shape, dtype=_torch_dtype(idxs),
                                device=dev)
        self.lr = torch.zeros(self.k, dtype=torch.float32, device=dev)
        self.carry = _carry(state)
        super().__init__(state.generator, pool, lambda: trainer.steps_body(
            state, self.xs, self.idxs, self.lr))

    def binds(self, state) -> bool:
        now = _carry(state)
        return (state.generator is self.generator
                and len(now) == len(self.carry)
                and all(a is b for a, b in zip(now, self.carry)))

    def run(self, trainer, state, xs: np.ndarray, idxs: np.ndarray):
        if not self.binds(state):
            raise RuntimeError("the train state holds other tensors than "
                               "the graph captured: capture it again")
        with span("gdmcf.graphs.train.feed"):
            _feed(self.xs, xs)
            _feed(self.idxs, idxs)
            _feed(self.lr, trainer._lr_vector(state.step, self.k))
        with span("gdmcf.graphs.train.replay"):
            losses = self.replay().clone()
        state.step += self.k
        return state, losses


class EvalGraph(_Captured):
    """K eval steps (``Trainer.eval_step``) over static [K, B, W] rows, [K,
    B] ids and [K, B, W] masks (or the rows themselves); out: the top-k ids
    [K, B, top_k]."""

    def __init__(self, trainer, rows, uids, masks, sampling_steps: int,
                 top_k: int, generator: torch.Generator, pool):
        dev = trainer.device
        k = len(rows)

        def buf(items):
            if isinstance(items, np.ndarray):
                return torch.empty(items.shape, dtype=_torch_dtype(items),
                                   device=dev)
            return torch.empty((k,) + tuple(items[0].shape),
                               dtype=items[0].dtype, device=dev)

        self.xs, self.us = buf(rows), buf(uids)
        self.ms = None if masks is None else buf(masks)

        def body():
            return torch.stack([trainer.eval_step(
                self.xs[j], self.us[j],
                self.xs[j] if self.ms is None else self.ms[j],
                sampling_steps=sampling_steps, top_k=top_k,
                generator=generator) for j in range(k)])

        super().__init__(generator, pool, body)

    def run(self, rows: Batches, uids: Batches, masks) -> torch.Tensor:
        with span("gdmcf.graphs.eval.feed"):
            _feed(self.xs, rows)
            _feed(self.us, uids)
            if self.ms is not None:
                _feed(self.ms, masks)
        with span("gdmcf.graphs.eval.replay"):
            return self.replay()


def _shape_key(items: Batches):
    if isinstance(items, np.ndarray):
        return tuple(items.shape), str(items.dtype)
    return ((len(items),) + tuple(items[0].shape),
            str(items[0].dtype).replace("torch.", ""))


class TrainerGraphs:
    """A Trainer's graphs of its fused calls, one per group shape, in one
    memory pool; ``capture_s`` sums their capture times."""

    def __init__(self, trainer):
        self._trainer = weakref.ref(trainer)   # the Trainer owns this
        self.pool = torch.cuda.graph_pool_handle()
        self.train_graphs: Dict[tuple, TrainGraph] = {}
        self.eval_graphs: Dict[tuple, EvalGraph] = {}
        self.capture_s = 0.0
        self.captures = 0

    def _captured(self, g):
        self.capture_s += g.capture_s
        self.captures += 1
        return g

    def replays(self) -> int:
        return sum(g.replays for g in (*self.train_graphs.values(),
                                       *self.eval_graphs.values()))

    def train(self, state, xs: np.ndarray, idxs: np.ndarray):
        """One group of K host batches: a replay of the graph bound to
        ``state``, or without one the eager group, then the capture.
        Returns (state, the losses [K])."""
        tr = self._trainer()
        key = (_shape_key(xs), _shape_key(idxs))
        g = self.train_graphs.get(key)
        if g is not None and g.binds(state):
            return g.run(tr, state, xs, idxs)
        self.train_graphs.pop(key, None)   # its pool blocks go back
        dev = tr.device
        with span("gdmcf.graphs.train.eager"):
            state, losses = tr.train_steps(
                state, _pinned(xs).to(dev, non_blocking=True),
                _pinned(idxs).to(dev, non_blocking=True))
        with span("gdmcf.graphs.train.capture"):
            self.train_graphs[key] = self._captured(
                TrainGraph(tr, state, xs, idxs, self.pool))
        return state, losses

    def eval(self, rows: Batches, uids: Batches, masks, sampling_steps: int,
             top_k: int, generator: torch.Generator):
        """One group of eval batches (stacked host arrays or lists of
        device tensors; ``masks`` None: each batch masks with its rows):
        the ids [K, B, top_k] of a replay, good until the next replay, or
        the eager group's and then the capture."""
        tr = self._trainer()
        key = (_shape_key(rows), _shape_key(uids),
               None if masks is None else _shape_key(masks), sampling_steps,
               top_k)
        g = self.eval_graphs.get(key)
        if g is not None and g.generator is generator:
            return g.run(rows, uids, masks)
        self.eval_graphs.pop(key, None)
        k = len(rows)

        def dev(items, j):
            t = items[j]
            return (_pinned(t).to(tr.device, non_blocking=True)
                    if isinstance(t, np.ndarray) else t)

        out = []
        with span("gdmcf.graphs.eval.eager"):
            for j in range(k):
                x = dev(rows, j)
                out.append(tr.eval_step(
                    x, dev(uids, j), x if masks is None else dev(masks, j),
                    sampling_steps=sampling_steps, top_k=top_k,
                    generator=generator))
        with span("gdmcf.graphs.eval.capture"):
            self.eval_graphs[key] = self._captured(EvalGraph(
                tr, rows, uids, masks, sampling_steps, top_k, generator,
                self.pool))
        return torch.stack(out)
