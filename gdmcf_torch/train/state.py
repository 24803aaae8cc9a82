"""Train state: parameters, AdamW state, the importance sampler's state and
the step generator (the counterpart of the JAX package's ``TrainState``).

The port updates the module's parameters in place, so the state holds the
module's trainable tensors by name rather than a copy. Buffers (the
lightGCN backbone's ``frozen_*`` tables) are not parameters and get no
optimizer state.

Precision options, as the JAX package's ``create_train_state`` applies
them: ``param_dtype=bfloat16`` stores every parameter and the ``frozen_*``
tables in bfloat16; ``bf16_weights`` stores only the trainable tensors
whose JAX path (``tree_path``: ``in_layers/0/w``, ``embedding_item``, ...)
contains one of its patterns, never a ``frozen_*`` table. Each
bfloat16-stored trainable tensor gets a float32 master in the optimizer
state (``FusedAdamWState.master``). Every ``opt_impl`` runs the single-pass
AdamW: the JAX package's optimizer chain (``make_optimizer`` with
``with_f32_master``, ``with_selective_f32_master`` and
``scale_by_adam_lowp``) computes the same elementwise update on the same
masters, which the port's tests hold it to.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List

import torch

from gdmcf_torch.compat import tree_path
from gdmcf_torch.diffusion.engine import LtState
from gdmcf_torch.ops.fused_adamw import FusedAdamWState, fused_adamw_init


@dataclass
class TrainState:
    step: int                         # completed train steps
    params: Dict[str, torch.nn.Parameter]
    opt_state: FusedAdamWState
    lt: LtState
    generator: torch.Generator        # every draw of the train steps


def _frozen(name: str) -> bool:
    return any(part.startswith("frozen_") for part in name.split("."))


def bf16_weight_names(model: torch.nn.Module,
                      patterns: Iterable[str]) -> List[str]:
    """The trainable tensors ``bf16_weights`` selects: those whose JAX path
    contains any of ``patterns`` as a substring (the JAX package's
    ``bf16_weight_mask``). ``frozen_*`` tables never match: they are
    constants that keep full precision and get no optimizer state."""
    pats = tuple(patterns)
    return [name for name, p in model.named_parameters()
            if not _frozen(name)
            and any(s in tree_path(name, p.dim()) for s in pats)]


def cast_params_(cfg, model: torch.nn.Module) -> None:
    """Store the tensors ``cfg`` selects in bfloat16, in place (the same
    Parameter objects): under ``param_dtype=bfloat16`` every parameter and
    every ``frozen_*`` table (the JAX package casts its whole parameter
    tree, the frozen tables in it), under ``bf16_weights`` the selected
    trainable tensors."""
    if cfg.param_dtype == "bfloat16":
        names = [n for n, _ in model.named_parameters()]
        names += [n for n, b in model.named_buffers()
                  if _frozen(n) and b.is_floating_point()]
    elif cfg.bf16_weights:
        names = bf16_weight_names(model, cfg.bf16_weights)
    else:
        return
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    with torch.no_grad():
        for name in names:
            t = tensors[name]
            if t.dtype != torch.bfloat16:
                t.data = t.data.to(torch.bfloat16)


def create_train_state(cfg, model: torch.nn.Module, device) -> TrainState:
    """Zero moments in ``cfg.opt_moment_dtype``, a float32 master of each
    bfloat16-stored tensor (the model's storage is ``cast_params_``'s,
    applied when the Trainer builds it), an empty Lt ring, and a step
    generator seeded with ``cfg.random_seed + 1`` (parameter init draws
    from ``cfg.random_seed``)."""
    params = dict(model.named_parameters())
    moment_dtype = {"bfloat16": torch.bfloat16,
                    "float32": torch.float32}[cfg.opt_moment_dtype]
    return TrainState(
        step=0, params=params,
        opt_state=fused_adamw_init(params, moment_dtype),
        lt=LtState.create(cfg.steps, cfg.history_num_per_term, device),
        generator=torch.Generator(device).manual_seed(cfg.random_seed + 1))
