"""Plain PyTorch reference of the flagship recommender, for judging the port.

The model is ``DNNOneHotEmbeddingGCN`` with one hidden width ``D`` (the
recipes' ``dims``), written from the published description of GDMCF ("A
Graph-based Diffusion Model for Collaborative Filtering") and the recipe's
switches, with plain tensor operations: no kernel, cache, batching or
CUDA graph of the program under test, and nothing imported from it.

- ``weights``: every parameter drawn from the seed, leaf by leaf and in
  blocks of ``BLOCK`` elements, each block from a generator of its own, so
  that any block can be made again without the others. The benchmark
  writes these values into the program's parameters; the reference makes
  them again itself.
- ``scores``: the serving and evaluation path, the reverse loop at
  ``sampling_steps`` 0 (the model iterated from the clean rows through the
  posterior mean, T steps). The degree-guided graph growth is left out: on
  the directed GCN the user rows that the head reads receive only their
  self-loop, so the grown graph does not reach the scores.
- ``TrainReference``: the recipe's train step, drawing its randomness from
  a generator in the order the recipe draws it (the one-hot channel's
  timesteps and corruption, the model's timesteps, the Gaussian noise, the
  dropout of both tower inputs), with the importance sampler's loss ring,
  NT-Xent, the SNR weighting and AdamW with moments stored in the
  configuration's moment type.

Precision: float32 with TF32 off. ``lowp`` runs every matrix product in
bfloat16 (autocast): the control, one precision below the configuration's.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

BLOCK = 1 << 26          # elements drawn by one generator
GCN_HIDDEN = 512
TEMPERATURE = 0.1        # NT-Xent
NTXENT_EPS = 1e-5
CLOSS_WEIGHT = 0.1
UNIFORM_PROB = 0.001     # the importance sampler's floor
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


# -- shapes and weights -------------------------------------------------------

def param_shapes(n_user: int, n_item: int, dim: int,
                 emb_size: int) -> Dict[str, Tuple[int, ...]]:
    """The flagship's trainable tensors by the program's parameter names,
    Linear weights stored [out, in]."""
    d_item = 3 * dim
    return {
        "embedding_item": (n_item, d_item),
        "embedding_user": (n_user, dim),
        "sumW": (),
        "emb_layer.weight": (emb_size, emb_size),
        "emb_layer.bias": (emb_size,),
        "in_layers.0.weight": (dim, n_item + emb_size),
        "in_layers.0.bias": (dim,),
        "in_layers2.0.weight": (dim, 2 * n_item + emb_size),
        "in_layers2.0.bias": (dim,),
        "gcn.conv1.weight": (GCN_HIDDEN, d_item),
        "gcn.conv1.bias": (GCN_HIDDEN,),
        "gcn.conv2.weight": (d_item, GCN_HIDDEN),
        "gcn.conv2.bias": (d_item,),
    }


def n_params(shapes: Dict[str, Tuple[int, ...]]) -> int:
    return sum(math.prod(s) for s in shapes.values())


def _spread(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(centre, half-width) of a leaf's uniform draw: Glorot's range for
    matrices and tables, a small one for biases, and a blend weight inside
    (0, 1) so that both branches of the blend carry gradient."""
    if name == "sumW":
        return 0.5, 0.25
    if len(shape) == 1:
        return 0.0, 0.001 * math.sqrt(3.0)
    return 0.0, math.sqrt(6.0 / (shape[0] + shape[1]))


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    key = "/".join(str(t) for t in (int(seed),) + tags).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def _block_seed(seed: int, leaf: str, block: int) -> int:
    return derive_seed(seed, leaf, block)


@torch.no_grad()
def fill_leaf(out: torch.Tensor, seed: int, name: str) -> torch.Tensor:
    """Draw leaf ``name`` into ``out`` (float32, any device), in blocks of
    ``BLOCK`` elements; returns ``out``."""
    centre, half = _spread(name, tuple(out.shape))
    flat = out.view(-1)
    for b, lo in enumerate(range(0, max(flat.numel(), 1), BLOCK)):
        hi = min(lo + BLOCK, flat.numel())
        g = torch.Generator(out.device).manual_seed(_block_seed(seed, name, b))
        u = torch.rand(hi - lo, generator=g, device=out.device)
        flat[lo:hi] = u.mul_(2.0 * half).add_(centre - half)
    return out


def weights(seed: int, shapes: Dict[str, Tuple[int, ...]],
            device) -> Dict[str, torch.Tensor]:
    return {k: fill_leaf(torch.empty(s, device=device), seed, k)
            for k, s in shapes.items()}


# -- the diffusion's tables ----------------------------------------------------

class Tables:
    """The linear-variance beta schedule and what the recipe reads of it:
    computed in float64, kept in float32 as the recipe's tables are."""

    def __init__(self, steps: int, noise_scale: float, noise_min: float,
                 noise_max: float, device):
        ramp = np.linspace(noise_scale * noise_min, noise_scale * noise_max,
                           steps, dtype=np.float64)
        abar = 1.0 - ramp
        betas = [1.0 - abar[0]]
        for i in range(1, steps):
            betas.append(min(1.0 - abar[i] / abar[i - 1], 0.999))
        betas = np.array(betas, np.float64)
        betas[0] = 1e-5
        ac = np.cumprod(1.0 - betas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])

        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        self.steps = steps
        self.ac = f32(ac)
        self.sqrt_ac = f32(np.sqrt(ac))
        self.sqrt_1m_ac = f32(np.sqrt(1.0 - ac))
        self.coef1 = f32(betas * np.sqrt(ac_prev) / (1.0 - ac))
        self.coef2 = f32((1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac))

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        ac = self.ac[t]
        return ac / (1.0 - ac)


# -- the model -------------------------------------------------------------------

@contextlib.contextmanager
def precision(lowp: bool, device):
    """float32 products with TF32 off, or (``lowp``) bfloat16 products."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.autocast(torch.device(device).type, dtype=torch.bfloat16,
                            enabled=lowp):
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _linear(P, name, x):
    return torch.nn.functional.linear(x, P[name + ".weight"],
                                      P[name + ".bias"])


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def nt_xent(z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """-log(p_ii / sum_{j != i} p_ij) over the row softmax of z1 z2^T / tau,
    eps-guarded in numerator and denominator."""
    p = torch.softmax((z1 @ z2.T).float() / TEMPERATURE, dim=-1)
    diag = torch.diagonal(p)
    return -torch.log((diag + NTXENT_EPS)
                      / (p.sum(dim=1) - diag + NTXENT_EPS)).mean()


def forward(P, x, t, onehot, index, emb_size: int, dropout_u=None,
            want_closs: bool = False):
    """Scores [B, n] (and the contrastive loss). ``onehot`` [B, 2n] is the
    two-state corruption, interleaved per item; ``dropout_u`` the uniforms
    of the inverted dropout at rate 0.5 of (x, onehot), None in eval."""
    emb = _linear(P, "emb_layer", time_embedding(t, emb_size))
    if dropout_u is not None:
        u_x, u_o = dropout_u
        x = torch.where(u_x < 0.5, x / 0.5, torch.zeros_like(x))
        onehot = torch.where(u_o < 0.5, onehot / 0.5,
                             torch.zeros_like(onehot))
    h = torch.tanh(_linear(P, "in_layers.0", torch.cat([x, emb], 1)))
    h_u = torch.tanh(_linear(P, "in_layers2.0", torch.cat([onehot, emb], 1)))
    closs = nt_xent(h, h_u) if want_closs else None
    hc = torch.cat([h, h_u, P["embedding_user"][index]], 1).float()
    hidden = torch.nn.functional.leaky_relu(
        torch.relu(_linear(P, "gcn.conv1", hc)), 0.1)
    hc = hc * P["sumW"] + _linear(P, "gcn.conv2", hidden) * (1.0 - P["sumW"])
    table = P["embedding_item"]
    dots = (hc @ table.T).float()
    scores = dots / (torch.linalg.vector_norm(hc.float(), dim=1)[:, None]
                     * torch.linalg.vector_norm(table, dim=1)[None, :])
    return scores, closs


def clean_onehot(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([1.0 - x, x], dim=-1).reshape(x.shape[0], -1)


@torch.no_grad()
def scores(P, tables: Tables, x: torch.Tensor, index: torch.Tensor,
           emb_size: int, mask: torch.Tensor = None) -> torch.Tensor:
    """The serving path's scores [B, n] for dense rows ``x``: T model calls
    through the posterior mean from the clean rows, then ``mask`` (True:
    excluded) set to -inf."""
    onehot = clean_onehot(x)
    x_t = x
    for i in range(tables.steps - 1, -1, -1):
        t = torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)
        out, _ = forward(P, x_t, t, onehot, index, emb_size)
        x_t = tables.coef1[i] * out + tables.coef2[i] * x_t
    if mask is not None:
        x_t = x_t.masked_fill(mask, float("-inf"))
    return x_t


def top_ids(s: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k ids, ties toward the lowest index."""
    return torch.sort(s, dim=1, descending=True, stable=True)[1][:, :k]


# -- the train step ----------------------------------------------------------------

class TrainReference:
    """The recipe's train steps from weights ``P`` (updated in place) and a
    generator seeded like the program's step generator. Records each
    step's mean loss, the leaf norms of the first step's gradient, and the
    leaf norms of the change of the parameters since the start."""

    def __init__(self, P, tables: Tables, gen: torch.Generator, *,
                 emb_size: int, lr: float, discrete: float, history: int,
                 moment_dtype=torch.bfloat16):
        self.P = P
        for p in P.values():
            p.requires_grad_(True)
        self.tables = tables
        self.gen = gen
        self.emb_size = emb_size
        self.lr = lr
        self.discrete = discrete
        dev = next(iter(P.values())).device
        self.hist = torch.zeros((tables.steps, history), device=dev)
        self.count = [0] * tables.steps
        self.mu = {k: torch.zeros_like(p, dtype=moment_dtype)
                   for k, p in P.items()}
        self.nu = {k: torch.zeros_like(p, dtype=moment_dtype)
                   for k, p in P.items()}
        self.steps = 0
        self.losses: List[float] = []
        self.first_grad: Dict[str, float] = {}

    def _timesteps(self, b: int):
        steps, dev = self.tables.steps, self.hist.device
        full = all(c == self.hist.shape[1] for c in self.count)
        lt = torch.sqrt((self.hist ** 2).mean(dim=-1))
        imp = lt / lt.sum() * (1.0 - UNIFORM_PROB) + UNIFORM_PROB / steps
        t_uni = torch.randint(0, steps, (b,), generator=self.gen, device=dev)
        u = torch.rand((b,), generator=self.gen, device=dev)
        if not full:
            return t_uni, torch.ones((b,), device=dev)
        cdf = torch.cumsum(imp, dim=0)
        t = torch.searchsorted(cdf, u * cdf[-1], right=True).clamp(0,
                                                                  steps - 1)
        return t, imp[t] * steps

    def _ring(self, t: torch.Tensor, losses: torch.Tensor) -> None:
        h = self.hist.shape[1]
        t_host = t.cpu().numpy()
        for s in range(self.tables.steps):
            seq = torch.cat([self.hist[s, :self.count[s]],
                             losses[torch.from_numpy(t_host == s).to(
                                 losses.device)]])
            keep = seq[-h:]
            self.hist[s].zero_()
            self.hist[s, :keep.numel()] = keep
            self.count[s] = min(self.count[s] + int((t_host == s).sum()), h)

    def loss(self, x0: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """The step's mean loss, drawing as the recipe draws."""
        b, n = x0.shape
        dev, g, tb = x0.device, self.gen, self.tables
        t_u, _ = self._timesteps(b)
        a = (t_u.float() / b).clamp(0.0, 1.0)[:, None]
        p_one = (1.0 - a) * (1.0 - self.discrete)
        p_one = torch.where(x0 > 0.5, a + p_one, p_one)
        state = (torch.rand((b, n), generator=g, device=dev) < p_one).float()
        onehot = torch.stack([(1.0 - x0) * (1.0 - state), x0 * state],
                             dim=-1).reshape(b, 2 * n)
        t, pt = self._timesteps(b)
        noise = torch.randn((b, n), generator=g, device=dev)
        x_t = tb.sqrt_ac[t][:, None] * x0 + tb.sqrt_1m_ac[t][:, None] * noise
        u_x = torch.rand((b, n), generator=g, device=dev)
        u_o = torch.rand((b, 2 * n), generator=g, device=dev)
        out, closs = forward(self.P, x_t, t, onehot, index, self.emb_size,
                             (u_x, u_o), want_closs=True)
        mse = ((x0 - out.float()) ** 2).mean(dim=1)
        weight = torch.where(t == 0, 1.0, tb.snr(t - 1) - tb.snr(t))
        weighted = weight * mse
        self._ring(t, weighted.detach())
        return (weighted / pt + closs * CLOSS_WEIGHT).mean()

    def step(self, x0: torch.Tensor, index: torch.Tensor,
             lowp: bool = False) -> None:
        names = list(self.P)
        with precision(lowp, x0.device):
            loss = self.loss(x0, index)
        grads = torch.autograd.grad(loss, [self.P[k] for k in names])
        self.steps += 1
        self.losses.append(float(loss.detach()))
        cf = torch.tensor(float(self.steps), dtype=torch.float32)
        c1 = float(1.0 - torch.pow(torch.tensor(B1, dtype=torch.float32), cf))
        c2 = float(1.0 - torch.pow(torch.tensor(B2, dtype=torch.float32), cf))
        with torch.no_grad():
            for k, g in zip(names, grads):
                g = g.float()
                mu = B1 * self.mu[k].float() + (1.0 - B1) * g
                nu = B2 * self.nu[k].float() + (1.0 - B2) * g * g
                self.P[k].sub_(self.lr * ((mu / c1)
                                          / (torch.sqrt(nu / c2) + ADAM_EPS)))
                self.mu[k].copy_(mu)
                self.nu[k].copy_(nu)
                if self.steps == 1:   # as the optimizer holds it
                    self.first_grad[k] = first_grad_norm(self.mu[k])

    def change(self, seed: int) -> Dict[str, float]:
        """Leaf norms of the parameters' change since the weights of
        ``seed``, each start made again leaf by leaf."""
        out = {}
        with torch.no_grad():
            for k, p in self.P.items():
                start = fill_leaf(torch.empty_like(p), seed, k)
                out[k] = float(torch.linalg.vector_norm(p - start))
        return out


def first_grad_norm(mu: torch.Tensor) -> float:
    """The norm of the first step's gradient from the first moment after
    that step, mu = (1 - b1) g in the moment's storage type."""
    return float(torch.linalg.vector_norm(mu.float())) / (1.0 - B1)


def dense_rows(indptr: np.ndarray, indices: np.ndarray, users: Sequence[int],
               n_item: int, device) -> torch.Tensor:
    """Dense float32 rows of a CSR structure's users."""
    users = np.asarray(users, np.int64)
    out = torch.zeros((len(users), n_item), device=device)
    lens = indptr[users + 1] - indptr[users]
    rows = np.repeat(np.arange(len(users)), lens)
    cols = np.concatenate([indices[indptr[u]:indptr[u + 1]] for u in users]
                          ) if len(users) else np.zeros(0, np.int64)
    out[torch.from_numpy(rows).to(device),
        torch.from_numpy(cols.astype(np.int64)).to(device)] = 1.0
    return out
