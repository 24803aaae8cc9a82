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

The master form (``adamw_master_update_``) is the counterpart of the JAX
package's master branch of ``fused_adamw_apply``: for a tensor stored in
bfloat16 (``param_dtype=bfloat16`` or ``bf16_weights``) the update runs on
its float32 master ``w`` and writes the master and the storage,

    w'  = w - lr ((mu' / c1) / (sqrt(nu' / c2) + eps) + wd w)
    p'  = bfloat16(w')          (round to nearest even)

reading w (4 B), g (bfloat16, 2 B), mu, nu and writing w (4 B), p (2 B),
mu, nu: with bfloat16 moments 20 bytes per element too. It is a
``tl.constexpr`` branch of the same kernel, counted as
``fused_adamw_master``.

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
host sync per step. ``lr`` is a host float or a 0-d float32 device tensor:
the Trainer's fused call (``train/graphs.py``) captures K steps as a CUDA
graph, so each step reads its lr from a [K] device vector written before
every replay instead of a value frozen at capture. Division and square root use the correctly rounded
``div_rn``/``sqrt_rn`` (Triton's default f32 ``/`` and ``sqrt`` are
approximate). The compiler may contract ``b1 mu + (1 - b1) g`` into one
fused multiply-add, which moves a moment by one float32 ulp against plain
PyTorch and so, near a rounding boundary, a bfloat16 moment by one ulp.

Which path runs is decided by the tensors' device alone: CUDA tensors
launch the kernel or raise, CPU tensors take ``adamw_reference``. Triton is
imported, and its cache set to ``gdmcf_torch/_build/triton``, only when a
CUDA tensor first reaches the kernel.

Launch counts under CUDA graphs: ``LAUNCHES`` counts the kernel's runs. A
call made while the current stream captures a graph runs no kernel: it
adds to ``CAPTURED`` instead, the graph keeps the difference of
``CAPTURED`` across its capture, and every replay adds that to
``LAUNCHES`` (``add_replays``). So ``LAUNCHES`` is the eager launches
plus the captured launches times the replays, what a profiler counts.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
BLOCK = 2048        # elements per program
NUM_WARPS = 8       # 8 elements a thread

# launches since the last reset_launch_counts(); the wrapper adds one
# exactly where it launches the kernel, a graph's replay its captured ones
LAUNCHES = {"fused_adamw": 0, "fused_adamw_master": 0}
# calls recorded into a CUDA graph under capture (no kernel ran)
CAPTURED = {"fused_adamw": 0, "fused_adamw_master": 0}

_jit = None
tl = None   # triton.language, bound when the kernel is first built


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _count(name: str) -> None:
    """One launch of ``name`` on the current stream: a run, or under graph
    capture a recorded launch."""
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1


def add_replays(captured: Mapping[str, int], replays: int = 1) -> None:
    """Count ``replays`` replays of a graph that recorded ``captured``
    launches (its difference of ``CAPTURED`` across the capture)."""
    for name, n in captured.items():
        LAUNCHES[name] += n * replays


class FusedAdamWState(NamedTuple):
    """``count``: completed steps (0-d int32 on the device); ``mu``/``nu``:
    the moments of each trainable tensor, by parameter name; ``master``:
    the float32 master of each bfloat16-stored trainable tensor (None or
    empty when every tensor is float32)."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    master: Optional[Dict[str, torch.Tensor]] = None


def fused_adamw_init(params: Mapping[str, torch.Tensor],
                     moment_dtype: torch.dtype = torch.bfloat16
                     ) -> FusedAdamWState:
    """Zero moments in ``moment_dtype`` for every tensor of ``params``
    (the trainable ones: buffers such as ``frozen_*`` get none), and a
    float32 master, the stored value widened, for each bfloat16 one."""
    dev = next(iter(params.values())).device
    return FusedAdamWState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: torch.zeros_like(p, dtype=moment_dtype)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=moment_dtype)
            for k, p in params.items()},
        master={k: p.detach().float().clone()
                for k, p in params.items() if p.dtype == torch.bfloat16})


def step_scalars(count: torch.Tensor, lr, b1: float = 0.9,
                 b2: float = 0.999) -> torch.Tensor:
    """float32 [lr, c1, c2] on count's device for the step that makes
    ``count`` steps: c1 = 1 - b1^count, c2 = 1 - b2^count in float32.
    ``lr``: a host float, or a 0-d float32 tensor on count's device (read
    when the step runs, as a graph's replay needs)."""
    cf = count.to(torch.float32)
    if isinstance(lr, torch.Tensor):
        lr_t = lr.to(count.device, torch.float32).reshape(())
    else:
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


def adamw_master_reference(p: torch.Tensor, g: torch.Tensor,
                           mu: torch.Tensor, nu: torch.Tensor,
                           master: torch.Tensor, c: torch.Tensor, *,
                           b1: float = 0.9, b2: float = 0.999,
                           eps: float = 1e-8, wd: float = 0.0):
    """Plain version of the master form (the JAX package's master branch:
    ``_adamw_leaf_inline`` on the master, then the storage cast): returns
    new (p, mu, nu, master), inputs untouched."""
    new_m, new_mu, new_nu = adamw_reference(master, g, mu, nu, c, b1=b1,
                                            b2=b2, eps=eps, wd=wd)
    return new_m.to(p.dtype), new_mu, new_nu, new_m


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


def master_update_bounds(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                         nu: torch.Tensor, master: torch.Tensor,
                         c: torch.Tensor, **kw):
    """Bounds (p, mu, nu, master) on |master form - adamw_master_reference|
    after one step from the same inputs: the master, mu and nu as in
    ``update_bounds`` on the master; the stored p within the master's bound
    plus one ulp of its storage type (two roundings of values that far
    apart may land on neighbouring storage values)."""
    b_m, b_mu, b_nu = update_bounds(master, g, mu, nu, c, **kw)
    new_m = adamw_reference(master, g, mu, nu, c, **kw)[0]
    b_p = b_m + torch.finfo(p.dtype).eps * (new_m.abs() + b_m)
    return b_p, b_mu, b_nu, b_m


def _adamw_kernel(p_ptr, g_ptr, mu_ptr, nu_ptr, m_ptr, c_ptr, n, b1, omb1,
                  b2, omb2, eps, wd, BLOCK: "tl.constexpr",
                  MASTER: "tl.constexpr"):
    # one program per BLOCK elements of one flat tensor, updated in place;
    # MASTER: the math runs on the float32 master at m_ptr and p (bfloat16)
    # receives its rounding (without it m_ptr is never read)
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    lr = tl.load(c_ptr)
    c1 = tl.load(c_ptr + 1)
    c2 = tl.load(c_ptr + 2)
    if MASTER:
        w = tl.load(m_ptr + offs, mask=mask, other=0.0)
    else:
        w = tl.load(p_ptr + offs, mask=mask, other=0.0)
    g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    mu = tl.load(mu_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    nu = tl.load(nu_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    mu = b1 * mu + omb1 * g
    nu = b2 * nu + omb2 * g * g
    denom = tl.sqrt_rn(tl.div_rn(nu, c2)) + eps
    upd = tl.div_rn(tl.div_rn(mu, c1), denom)
    w = w - lr * (upd + wd * w)
    if MASTER:
        tl.store(m_ptr + offs, w, mask=mask)
        tl.store(p_ptr + offs, w.to(p_ptr.dtype.element_ty), mask=mask)
    else:
        tl.store(p_ptr + offs, w, mask=mask)
    tl.store(mu_ptr + offs, mu.to(mu_ptr.dtype.element_ty), mask=mask)
    tl.store(nu_ptr + offs, nu.to(nu_ptr.dtype.element_ty), mask=mask)


def build_kernel():
    """Import Triton (cache in ``gdmcf_torch/_build/triton``) and JIT-wrap
    the kernel; it compiles at its first launch for each form and moment
    dtype."""
    global _jit, tl
    if _jit is None:
        os.environ["TRITON_CACHE_DIR"] = str(BUILD_DIR / "triton")
        import triton
        import triton.language

        tl = triton.language
        _jit = triton.jit(_adamw_kernel)
    return _jit


def _check(p, g, mu, nu, c, master=None) -> None:
    extra = () if master is None else (("master", master),)
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu), ("c", c),
                    *extra):
        if not t.is_cuda or t.device != p.device:
            raise ValueError(f"{name} must be on {p.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("g", g), ("mu", mu), ("nu", nu), *extra):
        if t.shape != p.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != p shape "
                             f"{tuple(p.shape)}")
    if master is None:
        if p.dtype != torch.float32 or g.dtype != torch.float32:
            raise ValueError(f"p and g must be float32, got {p.dtype}, "
                             f"{g.dtype} (a bfloat16 p takes the master form)")
    elif (p.dtype != torch.bfloat16 or g.dtype != torch.bfloat16
          or master.dtype != torch.float32):
        raise ValueError(f"the master form takes p and g bfloat16 and the "
                         f"master float32, got {p.dtype}, {g.dtype}, "
                         f"{master.dtype}")
    if mu.dtype != nu.dtype or mu.dtype not in (torch.float32,
                                                torch.bfloat16):
        raise ValueError(f"mu and nu must be both float32 or both bfloat16, "
                         f"got {mu.dtype}, {nu.dtype}")
    if c.dtype != torch.float32 or c.shape != (3,):
        raise ValueError("c must be float32 [lr, c1, c2]")


def _no_dtensor(**tensors) -> None:
    for name, t in tensors.items():
        if isinstance(t, DTensor):
            raise TypeError(f"the AdamW update takes local tensors; {name} "
                            "is a DTensor: pass its to_local()")


def _launch(p, g, mu, nu, master, c, b1, b2, eps, wd) -> None:
    kernel = build_kernel()
    n = p.numel()
    with torch.cuda.device(p.device):
        kernel[(-(-n // BLOCK),)](
            p.detach(), g, mu, nu, p.detach() if master is None else master,
            c, n, b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, BLOCK=BLOCK,
            MASTER=master is not None, num_warps=NUM_WARPS)


def adamw_update_(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                  nu: torch.Tensor, c: torch.Tensor, *, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8,
                  wd: float = 0.0) -> None:
    """One AdamW step on one float32 tensor, in place on p, mu and nu.
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. Each tensor is a rank's own (local) tensor: a DTensor
    raises."""
    _no_dtensor(p=p, g=g, mu=mu, nu=nu)
    if not p.is_cuda:
        new_p, new_mu, new_nu = adamw_reference(p, g, mu, nu, c, b1=b1,
                                                b2=b2, eps=eps, wd=wd)
        with torch.no_grad():
            p.copy_(new_p)
        mu.copy_(new_mu)
        nu.copy_(new_nu)
        return
    _check(p, g, mu, nu, c)
    _launch(p, g, mu, nu, None, c, b1, b2, eps, wd)
    _count("fused_adamw")


def adamw_master_update_(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                         nu: torch.Tensor, master: torch.Tensor,
                         c: torch.Tensor, *, b1: float = 0.9,
                         b2: float = 0.999, eps: float = 1e-8,
                         wd: float = 0.0) -> None:
    """The master form: one AdamW step of a bfloat16-stored tensor p
    (gradient g bfloat16) on its float32 ``master``, in place on the
    master, p, mu and nu. CUDA tensors launch the kernel's master form (or
    raise); CPU tensors take ``adamw_master_reference``."""
    _no_dtensor(p=p, g=g, mu=mu, nu=nu, master=master)
    if not p.is_cuda:
        new_p, new_mu, new_nu, new_m = adamw_master_reference(
            p, g, mu, nu, master, c, b1=b1, b2=b2, eps=eps, wd=wd)
        with torch.no_grad():
            p.copy_(new_p)
        mu.copy_(new_mu)
        nu.copy_(new_nu)
        master.copy_(new_m)
        return
    _check(p, g, mu, nu, c, master)
    _launch(p, g, mu, nu, master, c, b1, b2, eps, wd)
    _count("fused_adamw_master")


def fused_adamw_apply(params: Mapping[str, torch.Tensor],
                      grads: Mapping[str, torch.Tensor],
                      state: FusedAdamWState, *, lr,
                      weight_decay: float = 0.0, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8
                      ) -> FusedAdamWState:
    """One AdamW step over every tensor of ``params``, in place (the JAX
    package returns new arrays; updating in place saves a copy of the
    model): the master form for a tensor with a master, the plain form
    otherwise. ``lr``: a float or a 0-d float32 device tensor
    (``step_scalars``). Returns the state with the step counted."""
    count = state.count + 1
    c = step_scalars(count, lr, b1, b2)
    masters = state.master or {}
    kw = dict(b1=b1, b2=b2, eps=eps, wd=weight_decay)
    for name, p in params.items():
        if name in masters:
            adamw_master_update_(p, grads[name], state.mu[name],
                                 state.nu[name], masters[name], c, **kw)
        else:
            adamw_update_(p, grads[name], state.mu[name], state.nu[name], c,
                          **kw)
    return state._replace(count=count)
