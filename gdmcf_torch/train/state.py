"""Train state: parameters, AdamW state, the importance sampler's state and
the step generator (the counterpart of the JAX package's ``TrainState``).

The port updates the module's parameters in place, so the state holds the
module's trainable tensors by name rather than a copy. Buffers (the
lightGCN backbone's ``frozen_*`` tables) are not parameters and get no
optimizer state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from gdmcf_torch.diffusion.engine import LtState
from gdmcf_torch.ops.fused_adamw import FusedAdamWState, fused_adamw_init


@dataclass
class TrainState:
    step: int                         # completed train steps
    params: Dict[str, torch.nn.Parameter]
    opt_state: FusedAdamWState
    lt: LtState
    generator: torch.Generator        # every draw of the train steps


def check_supported(cfg) -> None:
    """Raise for the optimizer options the port does not run yet."""
    if cfg.param_dtype != "float32":
        raise NotImplementedError(
            "param_dtype=bfloat16 (f32 master weights) is not ported yet: "
            "ROADMAP.md §A item 2, what waits")
    if cfg.bf16_weights:
        raise NotImplementedError(
            "bf16_weights (selective bf16 storage with f32 masters) is not "
            "ported yet: ROADMAP.md §A item 2, what waits")
    if cfg.opt_impl not in ("auto", "inline", "fused"):
        raise NotImplementedError(
            f"opt_impl={cfg.opt_impl!r} is not ported: the port's one "
            "optimizer is the single-pass AdamW, which every other value "
            "selects (ROADMAP.md §A item 2, what waits)")


def create_train_state(cfg, model: torch.nn.Module, device) -> TrainState:
    """Zero moments in ``cfg.opt_moment_dtype``, an empty Lt ring, and a
    step generator seeded with ``cfg.random_seed + 1`` (parameter init
    draws from ``cfg.random_seed``)."""
    check_supported(cfg)
    params = dict(model.named_parameters())
    moment_dtype = {"bfloat16": torch.bfloat16,
                    "float32": torch.float32}[cfg.opt_moment_dtype]
    return TrainState(
        step=0, params=params,
        opt_state=fused_adamw_init(params, moment_dtype),
        lt=LtState.create(cfg.steps, cfg.history_num_per_term, device),
        generator=torch.Generator(device).manual_seed(cfg.random_seed + 1))

