"""Plain SGL-ED pretraining (Wu et al., SIGIR 2021, arXiv:2010.10783), what
the program's SGL steps are held to. PyTorch and NumPy only: nothing of
the port and nothing of JAX; LightGCN's pieces from ``reference.lightgcn``.

- ``normalized_view(csr, kept)``: a view's N_v and N_v^T, from the CSR's
  stored cells at the kept indices (membership), on the view's own
  degrees, as ``reference.lightgcn.normalized`` builds N.
- ``info_nce(q, keys, pos, temp)``: paper eq. 10 with the mean over the
  rows: the rows L2-normalized (``F.normalize``), logits the cosine over
  ``temp``, the denominator over every row of ``keys``, in one block.
- ``Pretrainer``: steps on given triples from a table, with the views
  given as kept-edge indices: the three propagations (N, N_1, N_2) by
  ``torch.sparse.mm``; LightGCN's BPR loss and L2 term, plus ``ssl_reg``
  times the InfoNCE of view 1's batch users against all of view 2's
  users and of view 1's positive items against all of view 2's items;
  the gradient by autograd over the whole table; textbook Adam; float32
  with TF32 off. ``lowp`` rounds the tables to bfloat16 before each
  product and the InfoNCE's operands before theirs (the control).
  Records each step's loss, the first gradient and the table.
- ``invalid_views(csr, views, ratio)``: views whose kept edges are not
  ``floor((1 - ratio) * nnz)`` distinct stored cells of the graph, and
  one more when the two views are the same.
- ``draw_views(nnz, ratio, rng)``: two views drawn plainly, for the
  control, which runs without the program.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from h100bench.reference import lightgcn as L


def kept_count(nnz: int, ratio: float) -> int:
    return int(math.floor((1.0 - ratio) * nnz))


def normalized_view(csr, kept, device):
    """(N_v, N_v^T) of the view that keeps ``csr``'s stored cells at
    ``kept``."""
    coo = csr.tocoo()
    idx = np.asarray(kept, np.int64)
    sub = sp.coo_matrix((coo.data[idx], (coo.row[idx], coo.col[idx])),
                        shape=csr.shape)
    return L.normalized(sub.tocsr(), device)


def info_nce(q, keys, pos, temp: float, lowp: bool = False):
    qs = L._round(F.normalize(q, dim=1), lowp) / temp
    kn = L._round(F.normalize(keys, dim=1), lowp)
    pos_logit = (qs * kn[pos]).sum(1)
    return (torch.logsumexp(qs @ kn.T, dim=1) - pos_logit).mean()


class Pretrainer:
    """The reference's SGL-ED steps from ``table`` on ``csr``'s graph and
    the two views ``views`` (kept-edge indices)."""

    def __init__(self, csr, views, table, n_layers: int, lr: float,
                 decay: float, ssl_reg: float, temp: float, device,
                 lowp: bool = False):
        self.ops = [L.normalized(csr, device)] + [
            normalized_view(csr, k, device) for k in views]
        self.n_user = csr.shape[0]
        self.n_layers, self.lr, self.decay = n_layers, lr, decay
        self.ssl_reg, self.temp, self.lowp = ssl_reg, temp, lowp
        self.e0 = torch.as_tensor(np.asarray(table, np.float32)).to(
            device).clone()
        self.m = torch.zeros_like(self.e0)
        self.v = torch.zeros_like(self.e0)
        self.t = 0
        self.losses, self.first_grad = [], None

    def loss(self, e0: torch.Tensor, triples) -> torch.Tensor:
        users, pos, neg = (torch.as_tensor(np.asarray(a, np.int64),
                                           device=e0.device)
                           for a in triples)
        (fu, fi), (fu1, fi1), (fu2, fi2) = (
            L.propagate(n, nt, e0, self.n_user, self.n_layers, self.lowp)
            for n, nt in self.ops)
        u, p, q = fu[users], fi[pos], fi[neg]
        bpr = torch.nn.functional.softplus(
            (u * q).sum(1) - (u * p).sum(1)).mean()
        item0 = e0[self.n_user:]
        reg = 0.5 * ((e0[users] ** 2).sum() + (item0[pos] ** 2).sum()
                     + (item0[neg] ** 2).sum()) / users.shape[0]
        ssl = info_nce(fu1[users], fu2, users, self.temp, self.lowp) \
            + info_nce(fi1[pos], fi2, pos, self.temp, self.lowp)
        return bpr + self.decay * reg + self.ssl_reg * ssl

    def step(self, triples) -> None:
        with L.no_tf32():
            e0 = self.e0.detach().requires_grad_(True)
            loss = self.loss(e0, triples)
            (g,) = torch.autograd.grad(loss, e0)
        self.losses.append(float(loss.detach()))
        if self.first_grad is None:
            self.first_grad = g.detach().clone()
        self.t += 1
        with torch.no_grad():
            self.m.mul_(L.B1).add_(g, alpha=1 - L.B1)
            self.v.mul_(L.B2).addcmul_(g, g, value=1 - L.B2)
            m_hat = self.m / (1 - L.B1 ** self.t)
            v_hat = self.v / (1 - L.B2 ** self.t)
            self.e0 -= self.lr * m_hat / (v_hat.sqrt() + L.EPS)


def invalid_views(csr, views, ratio: float) -> int:
    """Views whose kept edges are not ``floor((1 - ratio) * nnz)`` distinct
    stored cells of ``csr``, plus one when the two views are equal."""
    want = kept_count(csr.nnz, ratio)
    bad = 0
    for k in views:
        k = np.asarray(k)
        ok = (k.ndim == 1 and len(k) == want
              and (len(k) == 0 or (k.min() >= 0 and k.max() < csr.nnz))
              and len(np.unique(k)) == want)
        bad += not ok
    if len(views) == 2 and np.array_equal(np.sort(views[0]),
                                          np.sort(views[1])):
        bad += 1
    return bad


def draw_views(nnz: int, ratio: float, rng: np.random.Generator):
    """Two views: each ``kept_count`` indices of ``range(nnz)`` drawn
    without replacement, sorted."""
    return [np.sort(rng.choice(nnz, kept_count(nnz, ratio), replace=False))
            for _ in range(2)]
