"""Trainer: the model, the diffusion, the train step and the eval step.

Port of the JAX package's ``train/trainer.py``: the train step is unpack ->
``training_losses`` -> mean -> backward -> optional global-norm clip ->
AdamW (the single-pass update, a Triton kernel on CUDA tensors); the eval
step is unpack -> ``p_sample`` -> mask seen items -> exact top-k. Under
OneHotMatrix 1 both steps see each batch as the block adjacency
[B + n_item, B + n_item] (the model's width is n_item + batch_size, so a
partial batch cannot run through it: the config refuses drop_last false).
``train_epoch`` runs one process's epoch; ``evaluate`` (dense rows, cached
on the device) and ``evaluate_streaming`` (batches assembled from
``NativeCSR``) rank the catalog and sum the metrics on the device; ``fit``
is the reference's main loop: train, evaluate every ``eval_every`` epochs,
select on NDCG@topN[1], checkpoint, early-stop, resume.

The train step updates the parameters, the moments, the step count and
the Lt ring in place (the tensors of the ``TrainState`` stay the same
objects) and returns the loss as a device tensor: nothing in a step waits
for the host. The learning rate of a schedule is a function of the host's
step count, so it reaches the AdamW kernel through the same device scalar
as a constant one.

The fused calls, the counterparts of the JAX package's ``_train_multi`` and
``_eval_multi``: ``train_epoch`` groups ``train_steps_per_call`` batches
(``train_steps``: K steps over stacked batches, exactly the math of K
``train_step`` calls) and the evaluations group ``eval_batches_per_call``
batches, with the JAX package's rules for a trailing partial batch. On the
card a group is a CUDA graph (``train/graphs.py``): the first group runs
eagerly, the graph is captured after it and replayed for every later
group, in this epoch and the next ones; on the CPU a group runs as its
steps one after another, the plain version. On a mesh
(gloo collectives cannot be captured) and under ``debug_nans`` (a host
check after every step) K is 1: ``fused_k`` decides before any capture.

``compute_dtype`` maps to the matmul precision on the GPU, for training and
eval: ``bfloat16`` (the default) is the JAX package's "default" precision,
which on a GPU is TF32, so TF32 is on; ``float32`` turns TF32 off.
``param_dtype`` and ``bf16_weights`` set the parameters' storage: the
Trainer stores the selected tensors in bfloat16 when it builds the model
(``train.state.cast_params_``), each gets a float32 master in the AdamW
state, and K1's master form updates it (``ops/fused_adamw.py``).

On a (dp, mp) mesh (``mesh_dp * mesh_mp > 1``) the Trainer is one rank of a
world of dp * mp processes started by ``parallel.multihost.initialize``; a
mesh config without that world raises, and a world without a mesh config
too. The model's catalog-sized tensors are sharded over mp by
``parallel.sharding.DEFAULT_RULES``; each dp group trains on its own
block of every global batch (``train_step`` takes the rank's block;
``train_epoch`` feeds each dp group its ``RowSlice``), every rank draws the
global batch's randomness and keeps its rows (a ``parallel.rows.RowBlock``
passed to the engine), the gradients are summed over dp and AdamW (the
same kernel) updates each rank's own blocks. Evaluation batches are
dp-sharded (each dp group scores its block and the metric sums are reduced
bit-exactly at the end) unless ``eval_replicated``; the top-k is
shard-local and merged over mp. Only the main rank logs and writes
checkpoints; every rank restores them. Every option runs on a mesh: ops
that read across batch rows (NT-Xent, the transformer's attention, the
symmetric GCN's sums) read the whole batch while the model runs a block
(``_rows_of``), and OneHotMatrix 1 shards the rows of the whole batch's
block adjacency over dp (``_onehot_rows``).

``debug_nans`` is the port of ``jax_debug_nans``: a train step checks its
loss, runs its backward pass under ``torch.autograd.detect_anomaly`` and
checks the parameters and moments after the update, and ``eval_step``
checks the sampled scores; the first non-finite value raises
``FloatingPointError`` naming where it was found. Without the flag none of
this runs: no check, no sync.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from gdmcf_torch import resolve_device
from gdmcf_torch.data.loader import DiffusionDataset, epoch_batches, epoch_stop
from gdmcf_torch.data.prefetch import prefetched
from gdmcf_torch.diffusion.engine import Diffusion, LtState, TrainDraws
from gdmcf_torch.models.registry import build_model
from gdmcf_torch.ops.bitpack import is_binary, pack_rows, unpack_rows
from gdmcf_torch.ops.fused_adamw import fused_adamw_apply
from gdmcf_torch.ops.metrics import (MetricAccumulator,
                                     compute_topn_accuracy, print_results)
from gdmcf_torch.ops.topk import chunked_topk
from gdmcf_torch.parallel.rows import RowBlock
from gdmcf_torch.parallel.mesh import axis_group, axis_index, axis_size
from gdmcf_torch.parallel.multihost import is_main_process, process_count
from gdmcf_torch.train.state import (TrainState, cast_params_,
                                     create_train_state)
from gdmcf_torch.utils.profiling import span

# the knobs of the fused calls, by what they group
_FUSE_KNOBS = {"train": "train_steps_per_call",
               "eval": "eval_batches_per_call"}


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Set float32 matmul precision for the block, restore it after."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _finite_or_raise(what: str, t: torch.Tensor) -> None:
    """debug_nans: raise ``FloatingPointError`` if ``t`` holds a NaN or an
    infinity (one sync)."""
    if not bool(torch.isfinite(t).all()):
        raise FloatingPointError(f"debug_nans: a non-finite value in {what}")


@contextlib.contextmanager
def _nan_anomaly():
    """debug_nans: the block's backward passes run under anomaly detection
    with NaN checks, whose error is re-raised as ``FloatingPointError``."""
    with torch.autograd.detect_anomaly(check_nan=True):
        try:
            yield
        except RuntimeError as e:
            if "nan values" not in str(e):
                raise
            raise FloatingPointError(
                f"debug_nans: the backward pass: {e}") from e


def _rank_device(device) -> torch.device:
    """A mesh rank's device: the one named, or ``cuda:<local rank>`` for a
    bare ``cuda``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        from gdmcf_torch.parallel.multihost import local_rank

        lr, cards = local_rank(), torch.cuda.device_count()
        if lr >= cards:
            raise ValueError(
                f"local rank {lr} has no card of its own ({cards} CUDA "
                "devices): name the device (device='cuda:0', with "
                "initialize(backend='gloo')) to share one card between "
                "ranks")
        dev = torch.device("cuda", lr)
    return dev


def equal_shape_runs(items, k: int, key):
    """The runs (lists) of consecutive ``items`` of equal ``key(item)``,
    each at most ``k`` long: the JAX package's grouping of fused eval
    batches, where a trailing partial batch trims a run. A full run is
    yielded before the next item is taken."""
    run = []
    for item in items:
        if run and key(item) != key(run[0]):
            yield run
            run = []
        run.append(item)
        if len(run) == k:
            yield run
            run = []
    if run:
        yield run


class Trainer:
    def __init__(self, cfg, n_user: int, n_item: int, train_csr=None,
                 device=None):
        self.cfg = cfg
        self.n_user = n_user
        self.n_item = n_item
        self.mesh = None
        self.placements = None   # {name: spec} on a mesh
        device = cfg.device if device is None else device
        if cfg.mesh_dp * cfg.mesh_mp > 1 or process_count() > 1:
            # one rank of a (dp, mp) world: the mesh must cover the world
            # exactly; nothing runs quietly on one rank
            from gdmcf_torch.parallel.mesh import make_mesh

            self.device = _rank_device(device)
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self.mesh = make_mesh(cfg.mesh_dp, cfg.mesh_mp, self.device.type)
        else:
            self.device = resolve_device(device)
        # parameter init draws from one generator seeded by random_seed
        # (on a mesh every rank draws the whole model, then keeps its
        # blocks: the init of the single-device run)
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.random_seed)
        self.model = build_model(cfg, n_user, n_item, train_csr=train_csr,
                                 generator=self.generator,
                                 device=self.device)
        # param_dtype / bf16_weights storage, before any step or request
        cast_params_(cfg, self.model)
        if self.mesh is not None:
            from gdmcf_torch.parallel.sharding import shard_params

            self.placements = shard_params(self.model, self.mesh)
        self.model.eval()
        if cfg.noise_scale == 0.0 and getattr(self.model, "needs_graph",
                                              False):
            raise ValueError(
                f"noise_scale=0 cannot serve backbone {cfg.backbone}: the "
                "degenerate reverse path has no synthetic graph to feed it "
                "(the reference crashes there too); use a graph-free "
                "backbone for this ablation")
        self.diffusion = Diffusion.create(
            cfg, variant=cfg.diffusion_variant, device=self.device,
            index_in=self.model.needs_index)
        # TF32 only on the GPU: a CPU run stays in full float32
        self.tf32 = (self.device.type == "cuda"
                     and cfg.compute_dtype == "bfloat16")
        # decay horizon of an lr schedule; fit() fills 0 in from epochs x
        # steps per epoch before the first step
        self._lr_total_steps = int(cfg.lr_total_steps)
        self._lr_scheduled = (cfg.lr_schedule != "constant"
                              or cfg.lr_warmup_steps > 0)
        # device-resident eval batches and packed ground truth, cached
        # across evaluations (matched by ``is``, at most 4 entries each)
        self._eval_cache = []
        self._gt_cache = []
        # the CUDA graphs of the fused calls (train/graphs.py), made at the
        # first group on the card; the evaluations' generator
        self._graphs = None
        self._eval_gen = None

    def init_state(self) -> TrainState:
        return create_train_state(self.cfg, self.model, self.device)

    def num_params(self, state: TrainState) -> int:
        """Elements of the whole model (a sharded tensor counts whole)."""
        from gdmcf_torch.parallel.sharding import shard_of

        return sum(p.numel() * (shard_of(p).count if shard_of(p) else 1)
                   for p in state.params.values())

    # -- the mesh ------------------------------------------------------------
    def _dp(self) -> int:
        return axis_size(self.mesh, "dp")

    def row_block(self, block: int) -> Optional[RowBlock]:
        """This rank's ``RowBlock`` when it holds its dp group's ``block``
        rows of a batch sharded over dp (None without one). ``train_step``
        and the evaluations make their own; a caller that hands
        ``eval_step`` its dp block of a batch passes it."""
        dp = self._dp()
        if dp == 1:
            return None
        i = axis_index(self.mesh, "dp")
        return RowBlock(i * block, (i + 1) * block, block * dp,
                        axis_group(self.mesh, "dp"))

    @contextlib.contextmanager
    def _rows_of(self, block: Optional[RowBlock]):
        """The model's forward within runs on ``block``'s rows of a
        dp-sharded batch (None: the whole batch): its ops that read across
        batch rows read the whole batch through ``batch_group``."""
        self.model.batch_group = None if block is None else block.group
        try:
            yield
        finally:
            self.model.batch_group = None

    def _put_batch(self, x: np.ndarray, idx: np.ndarray,
                   replicate: bool = False):
        """Host rows and ids -> device tensors. On a mesh, ``replicate``:
        every rank passes the identical full batch; otherwise the rows are
        this rank's dp block (``_put_batch_multihost``)."""
        if self.mesh is not None and not replicate:
            return self._put_batch_multihost(x, idx)
        return self._to_device(x), self._to_device(idx)

    def _put_batch_multihost(self, x: np.ndarray, idx: np.ndarray):
        """A dp block of a global batch: every dp group must feed a block
        of the same size (the global batch is their concatenation in dp
        order), or the collective steps would misalign."""
        from gdmcf_torch.parallel.multihost import allgather_host_vectors

        dp = self._dp()
        if dp > 1:
            sizes = allgather_host_vectors(
                np.asarray([x.shape[0], idx.shape[0]], np.int64),
                group=axis_group(self.mesh, "dp"))
            if (sizes != sizes[0]).any() or sizes[0][0] != sizes[0][1]:
                raise ValueError(
                    f"dp groups feed blocks of {sizes[:, 0].tolist()} rows "
                    f"and {sizes[:, 1].tolist()} ids: the global batch must "
                    f"divide evenly over mesh dp={dp}")
        return self._to_device(x), self._to_device(idx)

    def fused_k(self, kind: str):
        """(K, why K is 1 or None) of the fused ``kind`` call ("train" or
        "eval"): the config's ``train_steps_per_call`` or
        ``eval_batches_per_call``, or 1 on a mesh (gloo collectives cannot
        be captured in a CUDA graph) and under ``debug_nans`` (a host check
        after every step); the JAX package fuses both."""
        k = max(int(getattr(self.cfg, _FUSE_KNOBS[kind])), 1)
        if k > 1 and self.mesh is not None:
            return 1, "a mesh: gloo collectives cannot be captured"
        if k > 1 and self.cfg.debug_nans:
            return 1, "debug_nans: a host check after every step"
        return k, None

    def unfused_line(self) -> Optional[str]:
        """``fit``'s log line when a fused call the config asks for runs one
        step at a time (``fused_k``), where the JAX package fuses; None
        otherwise."""
        parts, why = [], None
        for kind, knob in _FUSE_KNOBS.items():
            _, why_k = self.fused_k(kind)
            if why_k is not None:
                parts.append(f"{knob} {getattr(self.cfg, knob)}")
                why = why_k
        if not parts:
            return None
        return f"{' and '.join(parts)} run one step at a time: {why}"

    def graphs(self):
        """The Trainer's CUDA graphs of the fused calls (card only)."""
        if self._graphs is None:
            from gdmcf_torch.train.graphs import TrainerGraphs

            self._graphs = TrainerGraphs(self)
        return self._graphs

    def _lr_vector(self, step: int, k: int) -> np.ndarray:
        """float32 [k]: ``_lr_at`` of the k steps from ``step`` on."""
        return np.asarray([self._lr_at(step + j) for j in range(k)],
                          np.float32)

    def _lr_at(self, step: int) -> float:
        """Learning rate of the step that starts at ``step`` completed
        steps: linear warmup over ``lr_warmup_steps``, then cosine or linear
        decay over ``lr_total_steps``. float32 arithmetic, as the JAX
        package computes it."""
        cfg = self.cfg
        if not self._lr_scheduled:
            return cfg.lr
        f32 = np.float32
        s = f32(step)
        lr = f32(cfg.lr)
        if cfg.lr_warmup_steps > 0:
            lr = lr * np.minimum((s + f32(1.0)) / f32(cfg.lr_warmup_steps),
                                 f32(1.0))
        if cfg.lr_schedule != "constant" and self._lr_total_steps > 0:
            frac = np.clip(s / f32(self._lr_total_steps), f32(0.0), f32(1.0))
            if cfg.lr_schedule == "cosine":
                lr = lr * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac))
            else:   # linear
                lr = lr * (f32(1.0) - frac)
        return float(lr)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor. On CUDA through pinned memory and a
        non-blocking copy: a copy from pageable memory would wait for the
        stream, so host batch assembly could not overlap the device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _check_packed_width(self, x: torch.Tensor) -> None:
        want = (self.n_item + 7) // 8
        if x.shape[-1] != want:
            raise ValueError(
                f"uint8 batch last dim {x.shape[-1]} != ceil(n_item/8)="
                f"{want}: uint8 means the bit-packed wire format")

    def _unpack(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            self._check_packed_width(x)
            return unpack_rows(x, self.n_item)
        return x.float()

    @staticmethod
    def _to_block_onehot(x: torch.Tensor, lo: int = 0,
                         hi: Optional[int] = None) -> torch.Tensor:
        """OneHotMatrix 1: rows ``lo:hi`` (default all) of the [B + n,
        B + n] adjacency whose upper-right block is the [B, n] rows (the
        reference's adjacency_to_one_hot)."""
        b, n = x.shape
        hi = b + n if hi is None else hi
        y = x.new_zeros((hi - lo, b + n))
        users = x[lo:max(min(hi, b), lo)]
        y[:users.shape[0], b:] = users
        return y

    def _onehot_rows(self, x: torch.Tensor, index: torch.Tensor,
                     block: Optional[RowBlock]):
        """OneHotMatrix 1: (the rows of the block adjacency this rank
        runs, the batch's ids, their ``RowBlock`` or None). Each row of the
        [B + n, B + n] adjacency spans every batch row's columns, so a dp
        block of B/dp user rows gathers the whole batch over dp and keeps
        its contiguous (B + n)/dp rows of the adjacency; when dp does not
        divide B + n every rank runs the whole adjacency (None), as the
        JAX package's ``compatible_spec`` replicates a dimension the axis
        does not divide."""
        if block is None:
            return self._to_block_onehot(x), index, None
        x, index = block.gather(x), block.gather(index)
        total = x.shape[0] + x.shape[1]
        dp = self._dp()
        if total % dp:
            return self._to_block_onehot(x), index, None
        i, rows = axis_index(self.mesh, "dp"), total // dp
        rows_of = RowBlock(i * rows, (i + 1) * rows, total, block.group)
        return (self._to_block_onehot(x, rows_of.lo, rows_of.hi), index,
                rows_of)

    # -- training ----------------------------------------------------------
    def loss_and_grads(self, state: TrainState, x: torch.Tensor,
                       index: torch.Tensor,
                       draws: Optional[TrainDraws] = None):
        """Forward and backward of one batch: (mean loss, grads by
        parameter name, each in its parameter's type as under ``jax.grad``,
        the new LtState). Changes nothing in ``state`` except its
        generator's position."""
        x = self._unpack(x.to(self.device))
        index = index.to(self.device).long()
        block = self.row_block(x.shape[0])
        if self.cfg.OneHotMatrix == 1 and x.shape[-1] == self.n_item:
            # a caller may pass the block already ([B + n, B + n])
            x, index, block = self._onehot_rows(x, index, block)
        self.model.train()
        names = list(state.params)
        if block is not None and draws is None:
            # the whole batch's draws, as one device would draw them
            draws = self.diffusion.train_draws(
                state.lt, block.total, x.shape[1], state.generator,
                model=self.model, keep=block.cut)
        check = self.cfg.debug_nans
        with matmul_precision(self.tf32), self._rows_of(block), \
                (_nan_anomaly() if check else contextlib.nullcontext()):
            loss_vec, new_lt, _ = self.diffusion.training_losses(
                self.model, x, index, state.lt, reweight=self.cfg.reweight,
                generator=state.generator, draws=draws, block=block)
            if block is None:
                loss = objective = loss_vec.mean()
            else:
                # the mean over the global batch: each dp group's share;
                # the gradients sum over dp below
                objective = loss_vec.sum() / block.total
                loss = block.gather(loss_vec).mean()
            if check:
                _finite_or_raise(f"the loss at step {state.step}", loss)
            # a parameter off the path (the GCN at gcnLayerNum 0) gets
            # zeros, as under jax.grad
            grads = torch.autograd.grad(
                objective, [state.params[k] for k in names],
                allow_unused=True, materialize_grads=True)
        grads = {k: g.contiguous() for k, g in zip(names, grads)}
        if block is not None:
            from gdmcf_torch.parallel.collectives import all_reduce_

            group = axis_group(self.mesh, "dp")
            for g in grads.values():
                all_reduce_(g, group)
        return loss.detach(), grads, new_lt

    def apply_grads(self, state: TrainState, grads: Dict[str, torch.Tensor],
                    new_lt: LtState) -> TrainState:
        """The optional global-norm clip (float32 squares; each gradient
        keeps its parameter's type), then AdamW in place: K1's master form
        for a bfloat16-stored tensor. The step count and the Lt ring are
        written into the state's own tensors."""
        self._update(state, grads, new_lt, self._lr_at(state.step))
        if self.cfg.debug_nans:
            self._check_state(state)
        state.step += 1
        return state

    def _update(self, state: TrainState, grads: Dict[str, torch.Tensor],
                new_lt: LtState, lr) -> None:
        """``apply_grads`` at ``lr`` (a float or a 0-d device tensor)
        without the host's step count: what a CUDA graph captures."""
        if self.cfg.grad_clip_norm > 0.0:
            squares = [torch.sum(g.float() ** 2) for g in grads.values()]
            if self.mesh is not None:
                # the global norm: a sharded tensor's squares sum over mp;
                # the dp replicas already hold the reduced gradient
                from gdmcf_torch.parallel.collectives import all_reduce
                from gdmcf_torch.parallel.sharding import shard_of

                squares = [
                    all_reduce(sq, shard_of(state.params[k]).group)
                    if shard_of(state.params[k]) else sq
                    for k, sq in zip(grads, squares)]
            gn = torch.sqrt(sum(squares))
            scale = torch.clamp_max(
                self.cfg.grad_clip_norm / torch.clamp_min(gn, 1e-12), 1.0)
            grads = {k: (g.float() * scale).to(g.dtype)
                     for k, g in grads.items()}
        opt = state.opt_state
        counted = fused_adamw_apply(state.params, grads, opt, lr=lr,
                                    weight_decay=self.cfg.weight_decay)
        opt.count.copy_(counted.count)
        state.lt.history.copy_(new_lt.history)
        state.lt.count.copy_(new_lt.count)

    @staticmethod
    def _check_state(state: TrainState) -> None:
        """debug_nans: every parameter, moment and master after the update
        (K1's forms and the optax path alike write them)."""
        opt = state.opt_state
        for group, tensors in (("params", state.params), ("mu", opt.mu),
                               ("nu", opt.nu), ("master", opt.master or {})):
            for name, t in tensors.items():
                _finite_or_raise(f"{group}[{name!r}] after the AdamW update "
                                 f"of step {state.step}", t)

    def train_step(self, state: TrainState, x: torch.Tensor,
                   index: torch.Tensor, draws: Optional[TrainDraws] = None):
        """One optimizer step; returns (state, loss as a 0-d device
        tensor). x: [B, n_item] float rows or bit-packed uint8."""
        loss, grads, new_lt = self.loss_and_grads(state, x, index, draws)
        return self.apply_grads(state, grads, new_lt), loss

    def train_steps(self, state: TrainState, xs: torch.Tensor,
                    idxs: torch.Tensor, draws=None):
        """K optimizer steps over stacked batches (xs [K, B, n_item] rows
        or bit-packed, idxs [K, B]), the counterpart of the JAX package's
        ``_train_multi``: exactly the math of K ``train_step`` calls, with
        the same draws in the same order (``draws``: a list of K
        ``TrainDraws`` or None). Runs eagerly: on the CPU it is the plain
        version of a fused group, on the card the group that runs before a
        capture. Returns (state, the losses [K])."""
        k = xs.shape[0]
        dev = self.device
        lr = torch.from_numpy(self._lr_vector(state.step, k))
        losses = self.steps_body(
            state, xs.to(dev, non_blocking=True),
            idxs.to(dev, non_blocking=True),
            lr.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda"
            else lr, draws)
        state.step += k
        return state, losses

    def steps_body(self, state: TrainState, xs: torch.Tensor,
                   idxs: torch.Tensor, lr: torch.Tensor,
                   draws=None) -> torch.Tensor:
        """The K steps of ``train_steps`` on device tensors, step j at
        ``lr[j]``, every state tensor updated in place; returns the losses
        [K]. Reads nothing from the host and leaves ``state.step`` alone,
        so a CUDA graph captures it as it is."""
        losses = []
        for j in range(xs.shape[0]):
            loss, grads, new_lt = self.loss_and_grads(
                state, xs[j], idxs[j], None if draws is None else draws[j])
            self._update(state, grads, new_lt, lr[j])
            losses.append(loss)
            del grads
        return torch.stack(losses)

    def _train_group(self, state: TrainState, batches):
        """One fused group of host batches [(x, idx)]: one CUDA graph
        replay on the card (``TrainerGraphs.train``; the group before the
        capture runs eagerly), its steps one after another on the CPU.
        Returns (state, the losses [K])."""
        xs = np.stack([b[0] for b in batches])
        idxs = np.stack([b[1] for b in batches])
        if self.device.type == "cuda":
            return self.graphs().train(state, xs, idxs)
        return self.train_steps(state, torch.from_numpy(xs),
                                torch.from_numpy(idxs))

    def train_epoch(self, state: TrainState, dataset,
                    rng: np.random.Generator):
        """One pass over ``dataset`` (``DiffusionDataset`` or
        ``NativeCSR``) in shuffled batches of ``batch_size``; returns
        (state, the sum of the step losses). The losses stay on the device
        until the epoch ends. The batches are assembled
        ``prefetch_batches`` ahead on a host thread
        (``data.prefetch.prefetched``; 0 assembles each in turn), in the
        same order either way.

        ``train_steps_per_call`` K > 1 (``fused_k``) groups the batches as
        the JAX package's ``train_epoch`` does: each K in a row go to
        ``_train_group``; a trailing partial batch, which cannot stack
        with them, first drains the pending ones as single steps; fewer
        than K left at the end run as single steps. Every grouping gives
        the same steps, draws and losses as K = 1.

        Spans (``utils.profiling.span``): ``gdmcf.train.group`` around each
        fused group, ``gdmcf.train.single`` around each single step and
        ``gdmcf.train.loss_fetch`` around the losses' fetch at the end.

        On a mesh each dp group trains on its own ``RowSlice`` of the rows
        (``local_row_range``) with its 1/dp block of every global batch,
        and the trailing partial batch is always dropped: every group must
        run the same number of collective steps."""
        bs = self.cfg.batch_size
        drop_last = self.cfg.drop_last
        offset = 0
        if self.mesh is not None:
            from gdmcf_torch.data.loader import RowSlice
            from gdmcf_torch.parallel.multihost import local_row_range

            dp = self._dp()
            if bs % dp:
                raise ValueError(
                    f"batch_size {bs} must divide evenly over mesh dp={dp}: "
                    "each dp group feeds a contiguous 1/dp block of the "
                    "global batch")
            rows = local_row_range(len(dataset), self.mesh)
            dataset = RowSlice(dataset, rows)
            offset = rows.start
            bs //= dp
            drop_last = True
            if len(dataset) < bs:
                raise ValueError(
                    f"the dp group's shard has {len(dataset)} rows < its "
                    f"block of the batch {bs}: no full global batch can be "
                    "assembled (reduce batch_size or mesh dp)")
        pack = (self.cfg.wire_format == "packed"
                and getattr(dataset, "binary", False))
        k, _ = self.fused_k("train")
        losses, pending = [], []

        def single(state, x, idx):
            with span("gdmcf.train.single"):
                if self.mesh is not None:   # this rank's dp block, checked
                    x_t, idx_t = self._put_batch(x, idx)
                else:
                    x_t, idx_t = torch.from_numpy(x), torch.from_numpy(idx)
                state, loss = self.train_step(state, x_t, idx_t)
                losses.append(loss.reshape(1))
            return state

        # the host assembles the next batches on a thread of its own
        # (prefetch_batches ahead); the device copies stay on this one
        for x, idx in prefetched(
                epoch_batches(dataset, bs, rng, shuffle=self.cfg.shuffle,
                              drop_last=drop_last, packed=pack),
                depth=self.cfg.prefetch_batches):
            if offset:
                idx = idx + np.int32(offset)   # slice position -> user id
            if pending and x.shape != pending[0][0].shape:
                # a trailing partial batch cannot stack with the group:
                # the pending batches run as single steps before it
                for b in pending:
                    state = single(state, *b)
                pending.clear()
            pending.append((x, idx))
            if len(pending) == k:
                if k == 1:
                    state = single(state, x, idx)
                else:
                    with span("gdmcf.train.group"):
                        state, ls = self._train_group(state, pending)
                    losses.append(ls)
                pending.clear()
        for b in pending:   # fewer than K left: single steps
            state = single(state, *b)
        with span("gdmcf.train.loss_fetch"):
            total = float(torch.cat(losses).sum()) if losses else 0.0
        return state, total

    # -- eval --------------------------------------------------------------
    @torch.inference_mode()
    def eval_step(self, x: torch.Tensor, index: torch.Tensor,
                  mask: torch.Tensor, sampling_steps: int, top_k: int,
                  generator=None, draws=None, return_scores: bool = False,
                  block: Optional[RowBlock] = None):
        """p_sample -> mask seen items -> top-k item ids [B, top_k].
        OneHotMatrix 1 samples the block of the rows, zeroes scores <= 0.1
        and ranks the block's upper-right [B, n_item] part, as the
        reference does.

        ``return_scores`` also returns the masked scores before top-k.
        ``block``: x is this rank's ``row_block`` of a dp-sharded batch;
        ``draws``, if given, are its rows of the whole batch's. Under
        OneHotMatrix 1 a block runs its rows of the whole batch's block
        adjacency (``_onehot_rows``) and the scores are gathered over dp
        before this block's user rows are ranked."""
        self.model.eval()
        x = self._unpack(x)
        mask = self._unpack(mask)
        onehot_block = self.cfg.OneHotMatrix == 1
        rows, ids, run = x, index, block
        if onehot_block:
            rows, ids, run = self._onehot_rows(x, index, block)
        if run is not None and draws is None:
            # the whole batch's draws, as one device would draw them
            draws = self.diffusion.p_sample_draws(
                run.total, rows.shape[1], sampling_steps,
                self.cfg.sampling_noise, generator, x.device, keep=run.cut)
        with matmul_precision(self.tf32), self._rows_of(run):
            scores = self.diffusion.p_sample(
                self.model, rows, ids, sampling_steps=sampling_steps,
                sampling_noise=self.cfg.sampling_noise, generator=generator,
                draws=draws, block=run)
        if self.cfg.debug_nans:
            _finite_or_raise("the eval step's sampled scores", scores)
        if onehot_block:
            if run is not None:   # the whole adjacency's scores
                scores = run.gather(scores)
            b = ids.shape[0]
            scores = scores.masked_fill(scores <= 0.1, 0.0)[:b, b:]
            if block is not None:   # this block's users
                scores = scores[block.lo:block.hi]
        scores = scores.masked_fill(mask > 0, float("-inf"))
        n = scores.shape[1]
        mp = axis_size(self.mesh, "mp")
        if mp > 1 and n // mp >= top_k:
            # shard-local top-k + merge over mp: only [B, k] crosses; the
            # catalog pads with -inf to a multiple of mp
            from gdmcf_torch.ops.topk import sharded_topk

            pad = (-n) % mp
            if pad:
                scores = torch.nn.functional.pad(scores, (0, pad),
                                                 value=float("-inf"))
            _, idx = sharded_topk(self.mesh, scores, top_k)
            # padded columns win only in all--inf rows; keep ids in range
            idx = idx.clamp_max(n - 1)
            scores = scores[:, :n]
        else:
            _, idx = chunked_topk(scores, top_k)
        return (idx, scores) if return_scores else idx

    # -- evaluation --------------------------------------------------------
    def _eval_shardable(self, b: int) -> bool:
        """True when a size-``b`` eval batch dp-shards: each dp group
        scores its 1/dp block and the metric sums reduce bit-exactly at the
        end, instead of every rank scoring all rows."""
        if self.mesh is None or self.cfg.eval_replicated:
            return False
        dp = self._dp()
        return dp > 1 and b % dp == 0

    def _local_eval_slice(self, start: int, b: int):
        """This rank's (first row, length) of a size-``b`` sharded eval
        batch starting at global row ``start``: its dp group's block."""
        lb = b // self._dp()
        return start + axis_index(self.mesh, "dp") * lb, lb

    def _reduce_metric_acc(self, acc):
        """Sum the metric accumulators of the dp groups (one rank each:
        the mp ranks of a group hold the same sums; the bytes of the
        float64 sums travel exactly) and return the global result.
        Collective."""
        from gdmcf_torch.parallel.multihost import allgather_host_vectors

        acc._drain()
        payload = np.concatenate([acc.sums.ravel(),
                                  np.asarray([acc.n_users], np.float64)])
        total = allgather_host_vectors(payload)[::axis_size(self.mesh,
                                                            "mp")].sum(0)
        acc.sums = total[:-1].reshape(acc.sums.shape)
        acc.n_users = int(round(total[-1]))
        return acc.result()

    def _eval_generator(self, generator):
        """The evaluation's generator: the caller's, or the Trainer's own
        seeded anew with ``random_seed + 12345`` (one object, since an eval
        graph is bound to the generator it was captured with)."""
        if generator is not None:
            return generator
        if self._eval_gen is None:
            self._eval_gen = torch.Generator(self.device)
        return self._eval_gen.manual_seed(self.cfg.random_seed + 12345)

    def _eval_group(self, rows, uids, masks, top_k: int, generator):
        """The ids [n, B, top_k] (or a list of n [B, top_k]) of a group of
        n eval batches: stacked host arrays or lists of device tensors;
        ``masks`` None when each batch masks with its rows. One CUDA graph
        replay on the card (``TrainerGraphs.eval``; the ids are good until
        the next replay), the batches one after another on the CPU."""
        steps = self.cfg.sampling_steps
        if self.device.type == "cuda":
            return self.graphs().eval(rows, uids, masks, steps, top_k,
                                      generator)
        out = []
        for j in range(len(rows)):
            x, u = rows[j], uids[j]
            if isinstance(x, np.ndarray):
                x, u = self._put_batch(x, u, replicate=True)
            m = x if masks is None else masks[j]
            if isinstance(m, np.ndarray):
                m = self._to_device(m)
            out.append(self.eval_step(x, u, m, sampling_steps=steps,
                                      top_k=top_k, generator=generator))
        return out

    def evaluate(self, state: TrainState, eval_rows: np.ndarray,
                 gt_matrix: np.ndarray, mask_matrix: np.ndarray, topn,
                 generator: Optional[torch.Generator] = None,
                 drop_last: Optional[bool] = None):
        """Rank the catalog for each eval row; (precision, recall, NDCG,
        MRR) lists at ``topn``, rounded to 4 decimals.

        eval_rows: the model inputs (the train rows); gt_matrix: the
        ground-truth split; mask_matrix: the history to exclude (train, or
        train+valid for test). ``drop_last``: None is ``cfg.drop_last``;
        fit() passes False for the tst_w_val test eval, the one loader of
        the reference built without drop_last. One generator, seeded
        ``random_seed + 12345`` unless given, is consumed in batch order.
        ``state`` is accepted for the JAX signature: the port's parameters
        are the model's own tensors. ``eval_batches_per_call`` K > 1 fuses
        each of ``equal_shape_runs``' runs of batches (``_eval_group``),
        with the same draws in the same order as single batches.

        Binary ground truth is summed on the device against a bit-packed
        cache: the rankings never leave the device and the sums come back
        in one transfer per call. On a mesh, dp-sharded batches are
        accumulated by each dp group for its own rows and the sums reduced
        at the end; a batch that runs replicated (a partial one dp does not
        divide) is counted once, by the main rank."""
        cfg = self.cfg
        k, _ = self.fused_k("eval")
        generator = self._eval_generator(generator)
        cached = self._prepare_eval_batches(eval_rows, mask_matrix,
                                            drop_last=drop_last)
        top_k = int(max(topn))   # unsorted topN still ranks enough items
        use_reduce = any(c[4] for c in cached)
        gt_dev = None if use_reduce else self._prepare_gt_batches(
            gt_matrix, cached, eval_rows, mask_matrix, drop_last)
        acc = MetricAccumulator(topn)
        all_idx, kept_users = [], []

        def shape(i):   # (rows, mask, whether the mask is the rows)
            c = cached[i]
            return c[1].shape, c[3].shape, c[3] is c[1]

        # a fused group's ids are consumed before the next group runs
        for run in equal_shape_runs(range(len(cached)), k, shape):
            group = [cached[i] for i in run]
            if len(run) == 1:
                _, rows, uids, mask, sharded = group[0]
                ids = [self.eval_step(
                    rows, uids, mask, sampling_steps=cfg.sampling_steps,
                    top_k=top_k, generator=generator,
                    block=(self.row_block(rows.shape[0]) if sharded
                           else None))]
            else:
                same = group[0][3] is group[0][1]
                ids = self._eval_group(
                    [c[1] for c in group], [c[2] for c in group],
                    None if same else [c[3] for c in group], top_k,
                    generator)
            for i, idx in zip(run, ids):
                start, rows, uids, mask, sharded = cached[i]
                if use_reduce:
                    # a sharded entry holds this rank's rows: its rankings
                    # pair with the ground truth of its own users
                    if sharded or is_main_process():
                        acc.add(gt_matrix[start:start + rows.shape[0]], idx)
                elif gt_dev is not None:
                    acc.add_packed(gt_dev[i], idx, self.n_item)
                else:   # count-valued ground truth: the host path
                    all_idx.append(idx.cpu().numpy())
                    kept_users.append(np.arange(start,
                                                start + rows.shape[0]))
        if use_reduce:
            return self._reduce_metric_acc(acc)
        if gt_dev is not None:
            return acc.result()
        users = np.concatenate(kept_users)
        return compute_topn_accuracy(gt_matrix[users],
                                     np.concatenate(all_idx), topn)

    def _prepare_gt_batches(self, gt_matrix, cached, eval_rows, mask_matrix,
                            drop_last):
        """Bit-packed ground-truth slices on the device, one per eval batch
        of ``_prepare_eval_batches``, cached across evaluations. None when
        the ground truth is not binary (the host path takes it)."""
        drop = self.cfg.drop_last if drop_last is None else drop_last
        key = (gt_matrix, eval_rows, mask_matrix, self.cfg.batch_size, drop)
        for k, dev in self._gt_cache:
            if (k[0] is gt_matrix and k[1] is eval_rows
                    and k[2] is mask_matrix and k[3:] == key[3:]):
                return dev
        # the binary check runs on a cache miss only: two passes over the
        # dense ground truth per call would rival the eval itself
        dev = None
        if is_binary(gt_matrix):
            dev = [self._to_device(pack_rows(
                gt_matrix[start:start + rows.shape[0]]))
                for start, rows, *_ in cached]
        if len(self._gt_cache) >= 4:
            self._gt_cache.pop(0)
        self._gt_cache.append((key, dev))
        return dev

    def _prepare_eval_batches(self, eval_rows: np.ndarray,
                              mask_matrix: np.ndarray,
                              drop_last: Optional[bool] = None):
        """Device-resident eval batches (start, rows, uids, mask, sharded),
        cached across evaluations: the rows and masks are constant during
        training. Entries hold the source arrays and match them with ``is``
        (an ``id()`` of a collected temporary could be reused by another
        array). Bit-packed when the wire format is packed and both arrays
        are binary. A dp-sharded entry holds this rank's block only, and
        ``start`` is its first row."""
        cfg = self.cfg
        drop = cfg.drop_last if drop_last is None else drop_last
        for rows_ref, mask_ref, bs_key, drop_key, batches in self._eval_cache:
            if (rows_ref is eval_rows and mask_ref is mask_matrix
                    and bs_key == cfg.batch_size and drop_key == drop):
                return batches
        bs = cfg.batch_size
        stop = epoch_stop(eval_rows.shape[0], bs, drop)
        pack = (cfg.wire_format == "packed" and is_binary(eval_rows)
                and is_binary(mask_matrix))
        batches = []
        for start in range(0, stop, bs):
            b = min(bs, stop - start)
            sharded = self._eval_shardable(b)
            if sharded:   # this rank uploads its dp group's block only
                start, b = self._local_eval_slice(start, b)
            rows_np = eval_rows[start:start + b]
            rows, uids = self._put_batch(
                pack_rows(rows_np) if pack else rows_np,
                np.arange(start, start + rows_np.shape[0], dtype=np.int64),
                replicate=not sharded)
            if mask_matrix is eval_rows:
                # the train-rows evals mask with the array they score:
                # reuse the device rows instead of a second copy
                mask = rows
            else:
                mask_np = mask_matrix[start:start + rows_np.shape[0]]
                mask = self._to_device(pack_rows(mask_np) if pack
                                       else mask_np)
            batches.append((start, rows, uids, mask, sharded))
        if len(self._eval_cache) >= 4:   # bound the device memory held
            self._eval_cache.pop(0)
        self._eval_cache.append((eval_rows, mask_matrix, cfg.batch_size,
                                 drop, batches))
        return batches

    def evaluate_streaming(self, state: TrainState, input_csrs, gt_csr,
                           mask_csrs, topn,
                           generator: Optional[torch.Generator] = None,
                           drop_last: Optional[bool] = None):
        """Large-catalog eval: batches assembled from ``NativeCSR`` (O(nnz)
        host memory), metrics streamed through ``MetricAccumulator`` —
        nothing dense of size [n_user, n_item] exists on the host.

        input_csrs / mask_csrs: lists of NativeCSR whose per-row union is
        the model input / the history mask (e.g. [train] or [train,
        valid]). On a mesh as ``evaluate``: each dp group gathers, packs
        and scores its block of a shardable batch.
        ``eval_batches_per_call`` K > 1 fuses as ``evaluate`` does, each
        run of ``equal_shape_runs`` as one group once it is complete
        (``_eval_group``, one host->device copy of the stacked group
        through pinned memory).

        Spans (``utils.profiling.span``): per batch ``gdmcf.eval.assemble``
        (the union of its rows and its mask), ``gdmcf.eval.ground_truth``
        (its ground truth's gather and copy) and ``gdmcf.eval.metrics``
        (the metric sums enqueued); ``gdmcf.eval.group`` around each fused
        group's stack and call, ``gdmcf.eval.single`` around each batch run
        alone, and ``gdmcf.eval.fetch`` around the means' fetch at the
        end."""
        cfg = self.cfg
        k, _ = self.fused_k("eval")
        generator = self._eval_generator(generator)
        n = len(input_csrs[0])
        bs = cfg.batch_size
        drop = cfg.drop_last if drop_last is None else drop_last
        stop = epoch_stop(n, bs, drop)
        acc = MetricAccumulator(topn)
        top_k = int(max(topn))
        pack = cfg.wire_format == "packed"
        packed_gt = hasattr(gt_csr, "gather_packed")

        def union(csrs, idx):
            if pack and all(hasattr(c, "gather_packed") for c in csrs):
                # binary rows: the OR of the packed rows is the packed union
                out = csrs[0].gather_packed(idx)
                for c in csrs[1:]:
                    out = out | c.gather_packed(idx)
                return out
            out = csrs[0].gather(idx)
            for c in csrs[1:]:
                out = np.clip(out + c.gather(idx), 0.0, 1.0)
            return pack_rows(out) if pack else out

        starts = list(range(0, stop, bs))
        use_reduce = any(self._eval_shardable(min(s + bs, n) - s)
                         for s in starts)
        # the valid evaluation masks with its own input rows
        own_mask = list(mask_csrs) == list(input_csrs)

        def count(idx, sharded, pred):
            if use_reduce and not (sharded or is_main_process()):
                return   # a replicated batch counts once
            # bit-packed ground truth and on-device sums: dense [B, n_item]
            # rows would be the largest per-batch transfer
            with span("gdmcf.eval.ground_truth"):
                gt = (self._to_device(gt_csr.gather_packed(idx)) if packed_gt
                      else gt_csr.gather(idx))
            with span("gdmcf.eval.metrics"):
                if packed_gt:
                    acc.add_packed(gt, pred, self.n_item)
                else:
                    acc.add(gt, pred.cpu().numpy())

        def single(idx, rows, mask, sharded):
            with span("gdmcf.eval.single"):
                rows_d, idx_d = self._put_batch(rows, idx,
                                                replicate=not sharded)
                mask_d = rows_d if mask is rows else self._to_device(mask)
                pred = self.eval_step(
                    rows_d, idx_d, mask_d, sampling_steps=cfg.sampling_steps,
                    top_k=top_k, generator=generator,
                    block=self.row_block(idx.size) if sharded else None)
            count(idx, sharded, pred)

        def batches():   # (ids, rows, mask, sharded) in batch order
            for start in starts:
                idx = np.arange(start, min(start + bs, n), dtype=np.int64)
                sharded = self._eval_shardable(idx.size)
                if sharded:   # only on a mesh, where K is 1
                    lo, lb = self._local_eval_slice(start, idx.size)
                    idx = np.arange(lo, lo + lb, dtype=np.int64)
                with span("gdmcf.eval.assemble"):
                    rows = union(input_csrs, idx)
                    mask = rows if own_mask else union(mask_csrs, idx)
                yield idx, rows, mask, sharded

        for run in equal_shape_runs(batches(), k, lambda b: b[1].shape):
            if len(run) == 1:
                single(*run[0])
                continue
            with span("gdmcf.eval.group"):
                ids = self._eval_group(
                    np.stack([b[1] for b in run]),
                    np.stack([b[0] for b in run]),
                    None if own_mask else np.stack([b[2] for b in run]),
                    top_k, generator)
            for b, pred in zip(run, ids):
                count(b[0], b[3], pred)
        with span("gdmcf.eval.fetch"):
            if use_reduce:
                return self._reduce_metric_acc(acc)
            return acc.result()

    # -- the main loop -------------------------------------------------------
    def fit(self, train_csr, valid_csr, test_csr, log=print,
            checkpointer=None, metric_logger=None):
        """The reference's main loop: ``epochs`` of ``train_epoch`` (each
        shuffled by ``np.random.default_rng((random_seed, epoch))``, so a
        resumed run sees the permutations of an uninterrupted one), an
        evaluation of valid and test every ``eval_every`` epochs, selection
        on valid NDCG@topN[1] (``fidelity`` stores the TEST value as the
        best, the reference's quirk), a best-checkpoint stream and a
        ``periodic`` one (``ckpt_every``), early stop after
        ``early_stop_patience`` epochs without a new best, and ``resume``
        from the newer stream. ``host_dense`` chooses ``evaluate`` over
        dense rows or ``evaluate_streaming`` over ``NativeCSR``. Returns
        (state, the best epoch's test results).

        Training starts from the module's current parameters (a new Trainer
        holds its seeded init). ``train_steps_per_call`` and
        ``eval_batches_per_call`` fuse K steps and K eval batches
        (``train_epoch``, ``evaluate``): CUDA graphs on the card, captured
        in the first epoch and replayed after; a mesh and ``debug_nans``
        run them one at a time (``fused_k``), which ``fit`` logs.
        ``prefetch_batches`` sets ``train_epoch``'s host prefetch. On a mesh
        every rank runs ``fit``; only the
        main rank logs, and checkpoints are written by it from the whole
        tensors and restored by every rank."""
        cfg = self.cfg
        if not is_main_process():   # every rank computes, one rank speaks
            def log(*_a, **_k):
                return None
            metric_logger = None
        n_rows = cfg.n_user_cap or train_csr.shape[0]

        def dense_rows(csr):
            # slice -> astype -> toarray: peak memory O(n_rows x n_item) f32
            return csr[:n_rows].astype(np.float32).toarray()

        if cfg.host_dense:
            train_rows = dense_rows(train_csr)
            valid_gt = dense_rows(valid_csr)
            test_gt = dense_rows(test_csr)
            mask_tv = np.clip(train_rows + valid_gt, 0, 1)
            dataset = DiffusionDataset.from_rows(train_rows)
        else:
            from gdmcf_torch.data.native import NativeCSR
            train_n = NativeCSR.from_scipy(train_csr[:n_rows])
            # ground truth and masks are MEMBERSHIP: strict=False, so a
            # duplicate (uid, iid) pair in valid/test cannot stop the run
            valid_n = NativeCSR.from_scipy(valid_csr[:n_rows], strict=False)
            test_n = NativeCSR.from_scipy(test_csr[:n_rows], strict=False)
            dataset = train_n

        bs = cfg.batch_size
        # a mesh always drops the trailing partial batch (train_epoch)
        drop = cfg.drop_last or self.mesh is not None
        steps_per_epoch = max(len(dataset) // bs if drop
                              else -(-len(dataset) // bs), 1)
        if self._lr_scheduled and self._lr_total_steps == 0:
            # decay horizon = this run's optimizer steps, set before step 1
            self._lr_total_steps = cfg.epochs * steps_per_epoch

        state = self.init_state()
        log(f"Number of all parameters: {self.num_params(state)}")
        if self.unfused_line() is not None:
            log(self.unfused_line())

        if checkpointer is None and cfg.ckpt_dir:
            from gdmcf_torch.train.checkpoint import Checkpointer
            checkpointer = Checkpointer(cfg.ckpt_dir)
        periodic = None
        if checkpointer is not None and cfg.ckpt_every > 0:
            # a stream of its own rotation: periodic saves never rotate out
            # the best checkpoint
            from gdmcf_torch.train.checkpoint import Checkpointer
            periodic = Checkpointer(
                os.path.join(checkpointer.directory, "periodic"),
                max_to_keep=2)
        start_epoch = 1
        best_metric, best_epoch, best_results = -100.0, 0, None
        if checkpointer is not None and cfg.resume:
            # resume from whichever stream holds the newest step
            src, latest = checkpointer, checkpointer.latest_step()
            if periodic is not None:
                p_latest = periodic.latest_step()
                if p_latest is not None and (latest is None
                                             or p_latest > latest):
                    src, latest = periodic, p_latest
            if latest is not None:
                state = src.restore(state)
                start_epoch = state.step // steps_per_epoch + 1
                log(f"resumed from checkpoint at step {state.step} "
                    f"(epoch {start_epoch})")
                meta = src.load_extra()
                if meta is not None:
                    # model selection continues where it was, so the first
                    # eval after a resume is no spurious new best
                    best_metric = float(meta.get("best_metric", best_metric))
                    best_epoch = int(meta.get("best_epoch", best_epoch))
                    best_results = meta.get("best_results")
                else:   # no sidecar: do not early-stop at once
                    best_epoch = max(start_epoch - 1, 0)
        topn = cfg.topN
        for epoch in range(start_epoch, cfg.epochs + 1):
            if epoch - best_epoch >= cfg.early_stop_patience:
                log("-" * 18)
                log("Exiting from training early")
                break
            start_time = time.time()
            state, total_loss = self.train_epoch(
                state, dataset, np.random.default_rng((cfg.random_seed,
                                                       epoch)))

            if epoch % cfg.eval_every == 0:
                if cfg.host_dense:
                    valid_results = self.evaluate(
                        state, train_rows, valid_gt, train_rows, topn)
                    if cfg.tst_w_val:
                        # input rows == history mask (train+valid); the
                        # reference's test_twv_loader keeps the partial batch
                        test_results = self.evaluate(
                            state, mask_tv, test_gt, mask_tv, topn,
                            drop_last=False)
                    else:
                        test_results = self.evaluate(
                            state, train_rows, test_gt, mask_tv, topn)
                else:
                    valid_results = self.evaluate_streaming(
                        state, [train_n], valid_n, [train_n], topn)
                    test_inputs = ([train_n, valid_n] if cfg.tst_w_val
                                   else [train_n])
                    test_results = self.evaluate_streaming(
                        state, test_inputs, test_n, [train_n, valid_n], topn,
                        drop_last=False if cfg.tst_w_val else None)
                if is_main_process():
                    print_results(None, valid_results, test_results)
                if metric_logger is not None:
                    metric_logger.eval_results(epoch, "valid", topn,
                                               valid_results)
                    metric_logger.eval_results(epoch, "test", topn,
                                               test_results)

                # selection: index [2] is NDCG, cutoff topN[1] (the only
                # cutoff if just one is configured)
                sel = min(1, len(topn) - 1)
                if valid_results[2][sel] > best_metric:
                    if cfg.fidelity:
                        best_metric = test_results[2][sel]  # reference quirk
                    else:
                        best_metric = valid_results[2][sel]
                    best_epoch = epoch
                    best_results = test_results
                    if checkpointer is not None:
                        # background write; the next save or the end of
                        # fit joins it
                        checkpointer.save(state, extra={
                            "best_metric": float(best_metric),
                            "best_epoch": int(best_epoch),
                            "best_results": best_results}, block=False)

            if periodic is not None and epoch % cfg.ckpt_every == 0:
                # carries the current selection state, so a periodic resume
                # keeps best tracking too
                periodic.save(state, extra={
                    "best_metric": float(best_metric),
                    "best_epoch": int(best_epoch),
                    "best_results": best_results}, block=False)
            log("Runing Epoch {:03d} train loss {:.4f} costs {}".format(
                epoch, total_loss,
                time.strftime("%H: %M: %S",
                              time.gmtime(time.time() - start_time))))
            if metric_logger is not None:
                metric_logger.metrics(epoch, train_loss=total_loss,
                                      epoch_s=time.time() - start_time)
        log("=" * 54)
        log(f"End. Best Epoch {best_epoch:03d}")
        if best_results is not None and is_main_process():
            print_results(None, None, best_results)
        if checkpointer is not None:
            checkpointer.wait()   # commit any background save
        if periodic is not None:
            periodic.wait()
        return state, best_results
