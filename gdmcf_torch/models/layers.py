"""Layer primitives with the reference's initialization.

Port of the JAX package's ``models/layers.py``. Linear layers are ``nn.Linear``
(weight stored [out, in]; the JAX package stores [in, out]) initialized as
the reference does: Xavier-normal weight, N(0, 0.001) bias. Embedding tables
are Xavier-uniform. Every draw takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def linear_init(d_in: int, d_out: int, generator: torch.Generator,
                device=None) -> nn.Linear:
    """nn.Linear with Xavier-normal weight and N(0, 0.001) bias."""
    layer = nn.Linear(d_in, d_out, device=device)
    std = math.sqrt(2.0 / (d_in + d_out))
    with torch.no_grad():
        nn.init.normal_(layer.weight, 0.0, std, generator=generator)
        nn.init.normal_(layer.bias, 0.0, 0.001, generator=generator)
    return layer


def xavier_uniform(shape, generator: torch.Generator,
                   device=None) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    out = torch.empty(shape, device=device)
    return out.uniform_(-limit, limit, generator=generator)


def mlp_init(dims: Sequence[int], generator: torch.Generator,
             device=None) -> nn.ModuleList:
    """A stack of Linear layers over consecutive dim pairs."""
    return nn.ModuleList(linear_init(a, b, generator, device)
                         for a, b in zip(dims[:-1], dims[1:]))


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return layer(x)


def mlp_tanh(layers: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
    """tanh after every layer."""
    for layer in layers:
        h = torch.tanh(layer(h))
    return h


def mlp_out(layers: nn.ModuleList, h: torch.Tensor,
            act=torch.tanh) -> torch.Tensor:
    """Activation after every layer except the last."""
    for i, layer in enumerate(layers):
        h = layer(h)
        if i != len(layers) - 1:
            h = act(h)
    return h


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (scale 1/(1-p) at train)."""
    if not train or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal [cos || sin] timestep embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """Clamped-L2 normalization (torch.nn.functional.normalize)."""
    return x / torch.linalg.vector_norm(x, dim=dim,
                                        keepdim=True).clamp_min(eps)
