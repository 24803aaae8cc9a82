"""Layer primitives with the reference's initialization.

Port of the JAX package's ``models/layers.py``. Linear layers are ``Linear``,
an ``nn.Linear`` (weight stored [out, in]; the JAX package stores [in, out])
whose product promotes mixed types (below), initialized as
the reference does: Xavier-normal weight, N(0, 0.001) bias. Embedding tables
are Xavier-uniform; a GCN conv has a Glorot-uniform weight and a zero bias;
the transformer's encoder layers keep torch's defaults.
Every draw takes an explicit ``torch.Generator``.

Mixed types: a tensor may be stored in bfloat16 (``param_dtype``,
``bf16_weights``). jnp promotes the operands of a product, bfloat16 with
float32 to float32, and keeps bfloat16 where both are; ``F.linear`` and
``@`` refuse mixed types. So every product that can meet a bfloat16 tensor
and a float32 one goes through ``promote`` (``Linear``, ``LayerNorm``, the
cosine head, the GCN's convs), and a float32 pair takes the unchanged
float32 op. The frozen LightGCN tables are cast together, and every activation
after a promoted product is float32, so the other products never mix.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def promote(a: torch.Tensor, b: torch.Tensor):
    """a and b in their common type (jnp's promotion: bfloat16 with float32
    is float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


class Linear(nn.Linear):
    """``nn.Linear`` whose product promotes its operands. A float32 input
    and weight take ``nn.Linear``'s own op; any other pair computes jnp's
    ``x @ w + b``: the product in the common type, then the bias added
    (which promotes again)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype == self.bias.dtype == torch.float32:
            return super().forward(x)
        x, w = promote(x, self.weight)
        return F.linear(x, w) + self.bias


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that takes a gain and bias of another type than its
    input: the normalized input times the gain plus the bias, promoted (the
    JAX package's ``(x - mean) * rsqrt(var + eps) * g + b``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype == self.bias.dtype:
            return super().forward(x)
        return (F.layer_norm(x, self.normalized_shape, eps=self.eps)
                * self.weight + self.bias)


def linear_init(d_in: int, d_out: int, generator: torch.Generator,
                device=None) -> nn.Linear:
    """Linear with Xavier-normal weight and N(0, 0.001) bias."""
    layer = Linear(d_in, d_out, device=device)
    std = math.sqrt(2.0 / (d_in + d_out))
    with torch.no_grad():
        nn.init.normal_(layer.weight, 0.0, std, generator=generator)
        nn.init.normal_(layer.bias, 0.0, 0.001, generator=generator)
    return layer


def torch_linear_default(d_in: int, d_out: int, generator: torch.Generator,
                         device=None) -> nn.Linear:
    """Linear with torch's own default init drawn from ``generator``:
    U(+-1/sqrt(fan_in)) for the weight and for the bias (the transformer's
    encoder layers keep it; the reference re-inits only its MLPs)."""
    layer = Linear(d_in, d_out, device=device)
    bound = 1.0 / math.sqrt(d_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def xavier_uniform(shape, generator: torch.Generator,
                   device=None) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    out = torch.empty(shape, device=device)
    return out.uniform_(-limit, limit, generator=generator)


def gcn_conv_init(d_in: int, d_out: int, generator: torch.Generator,
                  device=None) -> nn.Linear:
    """GCNConv's default init (torch_geometric): Glorot-uniform weight,
    zero bias. Weight stored [out, in] like every ``nn.Linear``."""
    layer = Linear(d_in, d_out, device=device)
    with torch.no_grad():
        layer.weight.copy_(xavier_uniform((d_in, d_out), generator,
                                          device).T)
        layer.bias.zero_()
    return layer


def mlp_init(dims: Sequence[int], generator: torch.Generator,
             device=None) -> nn.ModuleList:
    """A stack of ``Linear`` layers over consecutive dim pairs."""
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
            generator: Optional[torch.Generator] = None,
            u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout (scale 1/(1-p) at train). ``u``: pre-drawn
    uniforms of x's shape (keep where ``u < 1 - rate``, as JAX's
    ``bernoulli``); otherwise they are drawn from ``generator``."""
    if not train or rate == 0.0:
        return x
    if u is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    keep = u.to(x.device) < (1.0 - rate)
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


def cosine_scores(user_vecs: torch.Tensor, item_table: torch.Tensor,
                  eps: float = 0.0) -> torch.Tensor:
    """Full-catalog cosine similarity head: one [B, D] @ [D, N] product,
    normalized. ``eps=0`` (the registry's choice under ``fidelity``) keeps
    the reference's unguarded denominator, so a zero-norm vector gives NaN
    scores; the corrected mode passes a small eps."""
    u_norm = torch.linalg.vector_norm(user_vecs, dim=1, keepdim=True)
    i_norm = torch.linalg.vector_norm(item_table, dim=1)
    denom = u_norm * i_norm[None, :]
    if eps:
        denom = denom.clamp_min(eps)
    u, items = promote(user_vecs, item_table)
    return (u @ items.T) / denom


# NT-Xent inner form: "softmax" materializes the normalized [B, B] matrix,
# "lse" needs only the row logsumexp and the diagonal, "remat" is the
# softmax form recomputed in the backward instead of stored; the same math.
# "auto" takes "lse" from a batch of _NT_XENT_LSE_MIN_BATCH rows on, as the
# JAX package does. Tests set the form directly.
_NT_XENT_IMPL = "auto"
_NT_XENT_LSE_MIN_BATCH = 4096


def _resolve_ntxent_impl(batch: int) -> str:
    if _NT_XENT_IMPL != "auto":
        return _NT_XENT_IMPL
    return "lse" if batch >= _NT_XENT_LSE_MIN_BATCH else "softmax"


def nt_xent_softmax_core(z1: torch.Tensor, z2: torch.Tensor,
                         temperature: float = 0.1,
                         eps: float = 1e-5) -> torch.Tensor:
    """The softmax form of ``nt_xent_loss``."""
    sim = (z1 @ z2.T) / temperature
    p = torch.softmax(sim, dim=-1)
    diag = torch.diagonal(p)
    neg_sum = p.sum(dim=1) - diag
    return -torch.log((diag + eps) / (neg_sum + eps)).mean()


def nt_xent_loss(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.1,
                 eps: float = 1e-5) -> torch.Tensor:
    """NT-Xent between the two tower latents. The reference's diagonal
    masking is commented out, so the softmax runs over the full row
    including the positive: loss = -log(diag / sum(off-diagonal)).

    ALWAYS-ON REPAIR (both forms): eps also guards the denominator. The
    reference guards only the numerator, so a positive that saturates the
    softmax drives the off-diagonal mass to 0 and the loss to inf."""
    impl = _resolve_ntxent_impl(z1.shape[0])
    if impl == "remat":
        # the [B, B] softmax recomputed in the backward instead of stored
        # (the JAX package's jax.checkpoint of the core). The core draws
        # nothing, so no RNG state is kept: reading the CUDA RNG state is
        # not allowed while a CUDA graph captures the step
        from torch.utils.checkpoint import checkpoint

        return checkpoint(nt_xent_softmax_core, z1, z2, temperature, eps,
                          use_reentrant=False, preserve_rng_state=False)
    if impl == "lse":
        # softmax rows sum to 1, so the off-diagonal mass is 1 - diag
        sim = (z1 @ z2.T) / temperature
        lse = torch.logsumexp(sim, dim=-1)
        diag = torch.exp(torch.diagonal(sim) - lse)
        neg_sum = 1.0 - diag
        return -torch.log((diag + eps) / (neg_sum + eps)).mean()
    if impl != "softmax":
        raise ValueError(f"unknown NT-Xent form {impl!r}")
    return nt_xent_softmax_core(z1, z2, temperature=temperature, eps=eps)
