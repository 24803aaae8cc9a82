"""Trainer: the model, the diffusion and the eval step.

Port of what serving needs from the JAX package's ``train/trainer.py``: the
eval step is unpack -> ``p_sample`` -> mask seen items -> exact top-k. Training
(the train step, AdamW, ``fit``) comes with the flagship slice.

``compute_dtype`` maps to the matmul precision on the GPU: ``bfloat16``
(the default) is the JAX package's "default" precision, which on a GPU is
TF32, so TF32 is on; ``float32`` turns TF32 off.
"""

from __future__ import annotations

import contextlib

import torch

from gdmcf_torch import resolve_device
from gdmcf_torch.diffusion.engine import Diffusion
from gdmcf_torch.models.registry import build_model
from gdmcf_torch.ops.bitpack import unpack_rows
from gdmcf_torch.ops.topk import chunked_topk


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
        self.diffusion = Diffusion.create(
            cfg, variant=cfg.diffusion_variant, device=self.device)
        # TF32 only on the GPU: a CPU run stays in full float32
        self.tf32 = (self.device.type == "cuda"
                     and cfg.compute_dtype == "bfloat16")

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

    @torch.inference_mode()
    def eval_step(self, x: torch.Tensor, index: torch.Tensor,
                  mask: torch.Tensor, sampling_steps: int, top_k: int,
                  generator=None, draws=None, return_scores: bool = False):
        """p_sample -> mask seen items -> top-k item ids [B, top_k].

        ``return_scores`` also returns the masked scores before top-k."""
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
