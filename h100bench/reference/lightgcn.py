"""Plain LightGCN BPR pretraining (He et al., SIGIR 2020), what the program's
pretraining steps are held to. PyTorch and NumPy only: nothing of the port
and nothing of JAX.

- ``initial_table(seed, rows, d)``: the Xavier-uniform [rows, d] start
  table, drawn by a CPU generator seeded with the seed (bound
  sqrt(6 / (rows + d))), what the configuration names as the weights.
- ``normalized(csr)``: N = D_u^{-1/2} R D_i^{-1/2} and N^T as float32
  sparse COO tensors, R the CSR's membership (every stored cell 1), the
  degrees counted from it here; a row or column with no cell gets 0. (The
  port adds 1e-9 to each degree before the power: at float32 that moves
  no value of a row or column with a cell.)
- ``propagate``: K layers ``u' = N i, i' = N^T u`` by ``torch.sparse.mm``,
  the final tables the mean over layers 0..K. ``lowp`` rounds each
  table to bfloat16 before each product (the control).
- ``Pretrainer``: steps on given (user, positive, negative) triples: the
  BPR loss, softplus(neg - pos score) averaged over the batch, plus
  ``decay`` times half the squared norms of the batch's layer-0 rows over
  the batch size; the gradient by autograd; Adam (b1 0.9, b2 0.999, eps
  1e-8 added after the square root, no decay), all in float32 with TF32
  off. Records each step's loss, the first step's gradient and the table.
- ``invalid_triples``: how many triples have a positive outside the
  user's row or a negative inside it.
- ``draw_triples``: BPR triples drawn plainly from a generator (users
  without replacement, a positive from the row, a negative rejected
  while in it), for the control, which runs without the program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def initial_table(seed: int, rows: int, dim: int) -> np.ndarray:
    """[rows, dim] float32, uniform in +-sqrt(6 / (rows + dim)) from
    ``torch.Generator().manual_seed(seed)``."""
    bound = (6.0 / (rows + dim)) ** 0.5
    gen = torch.Generator().manual_seed(seed)
    return torch.empty((rows, dim)).uniform_(-bound, bound,
                                             generator=gen).numpy()


def normalized(csr, device):
    """(N, N^T) as coalesced float32 sparse COO tensors on ``device``."""
    coo = csr.tocoo()
    rows = coo.row.astype(np.int64)
    cols = coo.col.astype(np.int64)
    n_user, n_item = csr.shape
    deg_u = np.bincount(rows, minlength=n_user).astype(np.float64)
    deg_i = np.bincount(cols, minlength=n_item).astype(np.float64)
    inv_u = np.where(deg_u > 0, 1.0 / np.sqrt(np.maximum(deg_u, 1)), 0.0)
    inv_i = np.where(deg_i > 0, 1.0 / np.sqrt(np.maximum(deg_i, 1)), 0.0)
    vals = torch.from_numpy((inv_u[rows] * inv_i[cols]).astype(np.float32))
    idx = torch.from_numpy(np.stack([rows, cols]))
    n = torch.sparse_coo_tensor(idx, vals, (n_user, n_item))
    nt = torch.sparse_coo_tensor(idx.flip(0), vals, (n_item, n_user))
    return n.to(device).coalesce(), nt.to(device).coalesce()


def _round(x: torch.Tensor, lowp: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if lowp else x


def propagate(n, nt, e0: torch.Tensor, n_user: int, n_layers: int,
              lowp: bool = False):
    """(final users, final items): the mean over layers 0..K."""
    u, i = e0[:n_user], e0[n_user:]
    us, its = [u], [i]
    for _ in range(n_layers):
        u, i = (torch.sparse.mm(n, _round(i, lowp)),
                torch.sparse.mm(nt, _round(u, lowp)))
        us.append(u)
        its.append(i)
    return (torch.stack(us).mean(0), torch.stack(its).mean(0))


class Pretrainer:
    """The reference's steps from ``table`` ([n_user + n_item, D]
    float32) on ``csr``'s graph."""

    def __init__(self, csr, table, n_layers: int, lr: float, decay: float,
                 device, lowp: bool = False):
        self.n, self.nt = normalized(csr, device)
        self.n_user = csr.shape[0]
        self.n_layers, self.lr, self.decay = n_layers, lr, decay
        self.lowp = lowp
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
        fu, fi = propagate(self.n, self.nt, e0, self.n_user, self.n_layers,
                           self.lowp)
        u, p, q = fu[users], fi[pos], fi[neg]
        bpr = torch.nn.functional.softplus(
            (u * q).sum(1) - (u * p).sum(1)).mean()
        item0 = e0[self.n_user:]
        reg = 0.5 * ((e0[users] ** 2).sum() + (item0[pos] ** 2).sum()
                     + (item0[neg] ** 2).sum()) / users.shape[0]
        return bpr + self.decay * reg

    def step(self, triples) -> None:
        with no_tf32():
            e0 = self.e0.detach().requires_grad_(True)
            loss = self.loss(e0, triples)
            (g,) = torch.autograd.grad(loss, e0)
        self.losses.append(float(loss.detach()))
        if self.first_grad is None:
            self.first_grad = g.detach().clone()
        self.t += 1
        with torch.no_grad():
            self.m.mul_(B1).add_(g, alpha=1 - B1)
            self.v.mul_(B2).addcmul_(g, g, value=1 - B2)
            m_hat = self.m / (1 - B1 ** self.t)
            v_hat = self.v / (1 - B2 ** self.t)
            self.e0 -= self.lr * m_hat / (v_hat.sqrt() + EPS)


def invalid_triples(csr, batches) -> int:
    """How many of ``batches``' ([n, 3, B]) triples have a positive outside
    the user's row or a negative inside it."""
    b = np.asarray(batches, np.int64).reshape(-1, 3, np.shape(batches)[-1])
    users = b[:, 0].ravel()
    n_item = csr.shape[1]
    keys = (np.repeat(np.arange(csr.shape[0], dtype=np.int64),
                      np.diff(csr.indptr)) * n_item
            + csr.indices.astype(np.int64))
    keys.sort()

    def held(items):
        k = users * n_item + items
        at = np.minimum(np.searchsorted(keys, k), len(keys) - 1)
        return keys[at] == k

    return int((~held(b[:, 1].ravel())).sum() + held(b[:, 2].ravel()).sum())


def draw_triples(csr, batch: int, rng: np.random.Generator) -> np.ndarray:
    """[3, batch] int64 triples: users without replacement (rows with a
    cell and a cell left out only), a positive from the row, a negative
    drawn until it lies outside the row."""
    deg = np.diff(csr.indptr)
    ok = np.flatnonzero((deg > 0) & (deg < csr.shape[1]))
    users = np.sort(rng.choice(ok, batch, replace=False))
    pos = np.empty(batch, np.int64)
    neg = np.empty(batch, np.int64)
    for j, u in enumerate(users):
        row = csr.indices[csr.indptr[u]:csr.indptr[u + 1]]
        pos[j] = row[rng.integers(len(row))]
        while True:
            c = int(rng.integers(csr.shape[1]))
            if c not in row:
                neg[j] = c
                break
    return np.stack([users, pos, neg])
