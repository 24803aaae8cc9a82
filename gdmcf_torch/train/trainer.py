"""Trainer: the model, the diffusion, the train step and the eval step.

Port of the JAX package's ``train/trainer.py``: the train step is unpack ->
``training_losses`` -> mean -> backward -> optional global-norm clip ->
AdamW (the single-pass update, a Triton kernel on CUDA tensors); the eval
step is unpack -> ``p_sample`` -> mask seen items -> exact top-k.
``train_epoch`` runs one process's epoch. ``fit``, ``evaluate`` and
checkpoints are ROADMAP.md §A item 3.

The train step updates the parameters, the moments and the Lt ring in
place and returns the loss as a device tensor: nothing in a step waits for
the host.

``compute_dtype`` maps to the matmul precision on the GPU, for training and
eval: ``bfloat16`` (the default) is the JAX package's "default" precision,
which on a GPU is TF32, so TF32 is on; ``float32`` turns TF32 off.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from gdmcf_torch import resolve_device
from gdmcf_torch.data.loader import epoch_batches
from gdmcf_torch.diffusion.engine import Diffusion, LtState, TrainDraws
from gdmcf_torch.models.registry import build_model
from gdmcf_torch.ops.bitpack import unpack_rows
from gdmcf_torch.ops.fused_adamw import fused_adamw_apply
from gdmcf_torch.ops.topk import chunked_topk
from gdmcf_torch.train.state import TrainState, create_train_state


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Set float32 matmul precision for the block, restore it after."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


class Trainer:
    def __init__(self, cfg, n_user: int, n_item: int, train_csr=None,
                 device=None):
        self.cfg = cfg
        self.n_user = n_user
        self.n_item = n_item
        self.device = resolve_device(cfg.device if device is None else device)
        if cfg.OneHotMatrix == 1:
            raise NotImplementedError(
                "OneHotMatrix=1 is not ported yet (ROADMAP.md §A item 5)")
        # parameter init draws from one generator seeded by random_seed
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.random_seed)
        self.model = build_model(cfg, n_user, n_item, train_csr=train_csr,
                                 generator=self.generator,
                                 device=self.device)
        self.model.eval()
        if cfg.noise_scale == 0.0 and getattr(self.model, "needs_graph",
                                              False):
            raise ValueError(
                f"noise_scale=0 cannot serve backbone {cfg.backbone}: the "
                "degenerate reverse path has no synthetic graph to feed it "
                "(the reference crashes there too); use a graph-free "
                "backbone for this ablation")
        self.diffusion = Diffusion.create(
            cfg, variant=cfg.diffusion_variant, device=self.device)
        # TF32 only on the GPU: a CPU run stays in full float32
        self.tf32 = (self.device.type == "cuda"
                     and cfg.compute_dtype == "bfloat16")

    def init_state(self) -> TrainState:
        return create_train_state(self.cfg, self.model, self.device)

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

    # -- training ----------------------------------------------------------
    def loss_and_grads(self, state: TrainState, x: torch.Tensor,
                       index: torch.Tensor,
                       draws: Optional[TrainDraws] = None):
        """Forward and backward of one batch: (mean loss, grads by
        parameter name, the new LtState). Changes nothing in ``state``
        except its generator's position."""
        x = self._unpack(x.to(self.device))
        index = index.to(self.device).long()
        self.model.train()
        names = list(state.params)
        with matmul_precision(self.tf32):
            loss_vec, new_lt, _ = self.diffusion.training_losses(
                self.model, x, index, state.lt, reweight=self.cfg.reweight,
                generator=state.generator, draws=draws)
            loss = loss_vec.mean()
            # a parameter off the path (the GCN at gcnLayerNum 0) gets
            # zeros, as under jax.grad
            grads = torch.autograd.grad(
                loss, [state.params[k] for k in names], allow_unused=True,
                materialize_grads=True)
        return (loss.detach(),
                {k: g.contiguous() for k, g in zip(names, grads)}, new_lt)

    def apply_grads(self, state: TrainState, grads: Dict[str, torch.Tensor],
                    new_lt: LtState) -> TrainState:
        """The optional global-norm clip, then AdamW in place."""
        if self.cfg.grad_clip_norm > 0.0:
            gn = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                for g in grads.values()))
            scale = torch.clamp_max(
                self.cfg.grad_clip_norm / torch.clamp_min(gn, 1e-12), 1.0)
            grads = {k: (g.float() * scale).to(g.dtype)
                     for k, g in grads.items()}
        state.opt_state = fused_adamw_apply(
            state.params, grads, state.opt_state, lr=self.cfg.lr,
            weight_decay=self.cfg.weight_decay)
        state.lt = new_lt
        state.step += 1
        return state

    def train_step(self, state: TrainState, x: torch.Tensor,
                   index: torch.Tensor, draws: Optional[TrainDraws] = None):
        """One optimizer step; returns (state, loss as a 0-d device
        tensor). x: [B, n_item] float rows or bit-packed uint8."""
        loss, grads, new_lt = self.loss_and_grads(state, x, index, draws)
        return self.apply_grads(state, grads, new_lt), loss

    def train_epoch(self, state: TrainState, dataset,
                    rng: np.random.Generator):
        """One pass over ``dataset`` (``DiffusionDataset`` or
        ``NativeCSR``) in shuffled batches of ``batch_size``; returns
        (state, the sum of the step losses). The losses stay on the device
        until the epoch ends. ``train_steps_per_call`` needs no grouping
        here: K fused steps of the JAX package are K single steps."""
        pack = (self.cfg.wire_format == "packed"
                and getattr(dataset, "binary", False))
        losses = []
        for x, idx in epoch_batches(dataset, self.cfg.batch_size, rng,
                                    shuffle=self.cfg.shuffle,
                                    drop_last=self.cfg.drop_last,
                                    packed=pack):
            state, loss = self.train_step(state, torch.from_numpy(x),
                                          torch.from_numpy(idx))
            losses.append(loss)
        total = float(torch.stack(losses).sum()) if losses else 0.0
        return state, total

    # -- eval --------------------------------------------------------------
    @torch.inference_mode()
    def eval_step(self, x: torch.Tensor, index: torch.Tensor,
                  mask: torch.Tensor, sampling_steps: int, top_k: int,
                  generator=None, draws=None, return_scores: bool = False):
        """p_sample -> mask seen items -> top-k item ids [B, top_k].

        ``return_scores`` also returns the masked scores before top-k."""
        self.model.eval()
        x = self._unpack(x)
        mask = self._unpack(mask)
        with matmul_precision(self.tf32):
            scores = self.diffusion.p_sample(
                self.model, x, index, sampling_steps=sampling_steps,
                sampling_noise=self.cfg.sampling_noise, generator=generator,
                draws=draws)
        scores = scores.masked_fill(mask > 0, float("-inf"))
        _, idx = chunked_topk(scores, top_k)
        return (idx, scores) if return_scores else idx
