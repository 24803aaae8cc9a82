"""Single-pass AdamW: a Triton kernel for CUDA tensors and its plain version.

Port of the JAX package's ``ops/fused_adamw.py``. The kernel replaces the
TPU kernel ``_adamw_kernel`` (launched by ``_adamw_leaf_kernel``): for each
trainable tensor it reads p, g (float32), mu and nu (bfloat16 or float32)
once and writes p, mu and nu back in place,

    mu' = b1 mu + (1 - b1) g
    nu' = b2 nu + (1 - b2) g^2
    p'  = p - lr ((mu' / c1) / (sqrt(nu' / c2) + eps) + wd p)

with all arithmetic in float32 and the moments rounded to their storage
type (round to nearest even).

What bounds it on an H100: bytes. There is no reuse and no product; with
bfloat16 moments it moves 20 bytes per element (p, g read at 4, mu, nu read
at 2, p written at 4, mu, nu written at 2) for 16 float32 operations,
so at 3.35 TB/s it is a memory stream. The design reads each stream once
with contiguous block loads (``BLOCK`` elements per program, 16 bytes a
thread for the bfloat16 streams) and writes in place, so nothing is
allocated. The TPU version's split at 65,536 elements and its 2-D VMEM
blocking existed for the TPU's launch cost and VMEM; here every trainable
tensor of any rank goes through the kernel as one flat range, one launch
per tensor.

``lr``, ``c1 = 1 - b1^count`` and ``c2 = 1 - b2^count`` reach the kernel as
a float32 device tensor [3], computed on the device as the JAX package
computes them (float32 powers of the step count): no recompile and no
host sync per step. Division and square root use the correctly rounded
``div_rn``/``sqrt_rn`` (Triton's default f32 ``/`` and ``sqrt`` are
approximate). The compiler may contract ``b1 mu + (1 - b1) g`` into one
fused multiply-add, which moves a moment by one float32 ulp against plain
PyTorch and so, near a rounding boundary, a bfloat16 moment by one ulp.

Which path runs is decided by the tensors' device alone: CUDA tensors
launch the kernel or raise, CPU tensors take ``adamw_reference``. Triton is
imported, and its cache set to ``gdmcf_torch/_build/triton``, only when a
CUDA tensor first reaches the kernel.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Mapping, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
BLOCK = 2048        # elements per program
NUM_WARPS = 8       # 8 elements a thread

# launches since the last reset_launch_counts(); the wrapper adds one
# exactly where it launches the kernel
LAUNCHES = {"fused_adamw": 0}

_jit = None
tl = None   # triton.language, bound when the kernel is first built


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class FusedAdamWState(NamedTuple):
    """``count``: completed steps (0-d int32 on the device); ``mu``/``nu``:
    the moments of each trainable tensor, by parameter name."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def fused_adamw_init(params: Mapping[str, torch.Tensor],
                     moment_dtype: torch.dtype = torch.bfloat16
                     ) -> FusedAdamWState:
    """Zero moments in ``moment_dtype`` for every tensor of ``params``
    (the trainable ones: buffers such as ``frozen_*`` get none)."""
    dev = next(iter(params.values())).device
    return FusedAdamWState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: torch.zeros_like(p, dtype=moment_dtype)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=moment_dtype)
            for k, p in params.items()})


def step_scalars(count: torch.Tensor, lr: float, b1: float = 0.9,
                 b2: float = 0.999) -> torch.Tensor:
    """float32 [lr, c1, c2] on count's device for the step that makes
    ``count`` steps: c1 = 1 - b1^count, c2 = 1 - b2^count in float32."""
    cf = count.to(torch.float32)
    lr_t = torch.full((), lr, dtype=torch.float32, device=count.device)
    return torch.stack([lr_t, 1.0 - b1 ** cf, 1.0 - b2 ** cf])


def adamw_reference(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                    nu: torch.Tensor, c: torch.Tensor, *, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8, wd: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel (the JAX package's
    ``_adamw_leaf_inline``): returns new (p, mu, nu), inputs untouched.
    ``c`` is ``step_scalars``' [lr, c1, c2]."""
    lr, c1, c2 = c[0], c[1], c[2]
    g32 = g.float()
    mu32 = b1 * mu.float() + (1.0 - b1) * g32
    nu32 = b2 * nu.float() + (1.0 - b2) * g32 * g32
    upd = (mu32 / c1) / (torch.sqrt(nu32 / c2) + eps)
    p32 = p.float()
    new_p = (p32 - lr * (upd + wd * p32)).to(p.dtype)
    return new_p, mu32.to(mu.dtype), nu32.to(nu.dtype)


def update_bounds(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                  nu: torch.Tensor, c: torch.Tensor, *, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8, wd: float = 0.0):
    """Per-element bounds (p, mu, nu) on |kernel - adamw_reference| after
    one step from the same inputs, the tolerance every comparison states.

    A fused multiply-add rounds a moment's sum once instead of twice, so a
    float32 moment may move by 4 float32 ulps of its summed terms and then
    round to the neighbouring value of its storage type (one ulp of that
    type). p may move by 4 float32 ulps of its own terms plus ``lr`` times
    the update's error that those moment errors and the two correctly
    rounded divisions and square root allow."""
    ulp = 2.0 ** -23
    lr, c1, c2 = c[0], c[1], c[2]
    g32, mu32, nu32, p32 = g.float(), mu.float(), nu.float(), p.float()
    mu_terms = (b1 * mu32).abs() + ((1.0 - b1) * g32).abs()
    nu_terms = (b2 * nu32).abs() + ((1.0 - b2) * g32 * g32).abs()
    new_mu = b1 * mu32 + (1.0 - b1) * g32
    new_nu = b2 * nu32 + (1.0 - b2) * g32 * g32
    den = torch.sqrt(new_nu / c2) + eps
    upd = (new_mu / c1) / den
    d_upd = 4 * ulp * mu_terms / (c1 * den) + 8 * ulp * upd.abs()
    b_p = 4 * ulp * (p32.abs() + lr * (upd.abs() + (wd * p32).abs())) \
        + lr * d_upd
    storage = torch.finfo(mu.dtype).eps
    b_mu = storage * new_mu.abs() + 4 * ulp * mu_terms
    b_nu = storage * new_nu.abs() + 4 * ulp * nu_terms
    return b_p, b_mu, b_nu


def _adamw_kernel(p_ptr, g_ptr, mu_ptr, nu_ptr, c_ptr, n, b1, omb1, b2,
                  omb2, eps, wd, BLOCK: "tl.constexpr"):
    # one program per BLOCK elements of one flat tensor, updated in place
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    lr = tl.load(c_ptr)
    c1 = tl.load(c_ptr + 1)
    c2 = tl.load(c_ptr + 2)
    p = tl.load(p_ptr + offs, mask=mask, other=0.0)
    g = tl.load(g_ptr + offs, mask=mask, other=0.0)
    mu = tl.load(mu_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    nu = tl.load(nu_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    mu = b1 * mu + omb1 * g
    nu = b2 * nu + omb2 * g * g
    denom = tl.sqrt_rn(tl.div_rn(nu, c2)) + eps
    upd = tl.div_rn(tl.div_rn(mu, c1), denom)
    p = p - lr * (upd + wd * p)
    tl.store(p_ptr + offs, p, mask=mask)
    tl.store(mu_ptr + offs, mu.to(mu_ptr.dtype.element_ty), mask=mask)
    tl.store(nu_ptr + offs, nu.to(nu_ptr.dtype.element_ty), mask=mask)


def build_kernel():
    """Import Triton (cache in ``gdmcf_torch/_build/triton``) and JIT-wrap
    the kernel; it compiles at its first launch for each moment dtype."""
    global _jit, tl
    if _jit is None:
        os.environ["TRITON_CACHE_DIR"] = str(BUILD_DIR / "triton")
        import triton
        import triton.language

        tl = triton.language
        _jit = triton.jit(_adamw_kernel)
    return _jit


def _check(p, g, mu, nu, c) -> None:
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu), ("c", c)):
        if not t.is_cuda or t.device != p.device:
            raise ValueError(f"{name} must be on {p.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("g", g), ("mu", mu), ("nu", nu)):
        if t.shape != p.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != p shape "
                             f"{tuple(p.shape)}")
    if p.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"p and g must be float32, got {p.dtype}, {g.dtype}")
    if mu.dtype != nu.dtype or mu.dtype not in (torch.float32,
                                                torch.bfloat16):
        raise ValueError(f"mu and nu must be both float32 or both bfloat16, "
                         f"got {mu.dtype}, {nu.dtype}")
    if c.dtype != torch.float32 or c.shape != (3,):
        raise ValueError("c must be float32 [lr, c1, c2]")


def adamw_update_(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                  nu: torch.Tensor, c: torch.Tensor, *, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8,
                  wd: float = 0.0) -> None:
    """One AdamW step on one tensor, in place on p, mu and nu. CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain
    version. Each tensor is a rank's own (local) tensor: a DTensor
    raises."""
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        if isinstance(t, DTensor):
            raise TypeError(f"adamw_update_ takes local tensors; {name} is a "
                            "DTensor: pass its to_local()")
    if not p.is_cuda:
        new_p, new_mu, new_nu = adamw_reference(p, g, mu, nu, c, b1=b1,
                                                b2=b2, eps=eps, wd=wd)
        with torch.no_grad():
            p.copy_(new_p)
        mu.copy_(new_mu)
        nu.copy_(new_nu)
        return
    _check(p, g, mu, nu, c)
    kernel = build_kernel()
    n = p.numel()
    with torch.cuda.device(p.device):
        kernel[(-(-n // BLOCK),)](
            p.detach(), g, mu, nu, c, n, b1, 1.0 - b1, b2, 1.0 - b2, eps,
            wd, BLOCK=BLOCK, num_warps=NUM_WARPS)
    LAUNCHES["fused_adamw"] += 1


def fused_adamw_apply(params: Mapping[str, torch.Tensor],
                      grads: Mapping[str, torch.Tensor],
                      state: FusedAdamWState, *, lr: float,
                      weight_decay: float = 0.0, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8
                      ) -> FusedAdamWState:
    """One AdamW step over every tensor of ``params``, in place (the JAX
    package returns new arrays; updating in place saves a copy of the
    model). Returns the state with the step counted."""
    count = state.count + 1
    c = step_scalars(count, lr, b1, b2)
    for name, p in params.items():
        adamw_update_(p, grads[name], state.mu[name], state.nu[name], c,
                      b1=b1, b2=b2, eps=eps, wd=weight_decay)
    return state._replace(count=count)
