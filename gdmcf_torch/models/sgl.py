"""SGL-ED: the two edge-dropped views and the InfoNCE that LightGCN's BPR
pretraining adds to its step.

Wu et al., *Self-supervised Graph Learning for Recommendation*, SIGIR 2021
(arXiv:2010.10783), edge-dropout variant. The encoder is LightGCN's,
``z = P e0`` (``models.lightgcn``). A view keeps ``floor((1 - ratio) *
nnz)`` of the graph's stored interactions, drawn uniformly without
replacement (``draw_kept``), the same cells in both directions, and is
normalized on its own degrees: ``N_v = D_{u,v}^-1/2 R_v D_{i,v}^-1/2``
(``Views.propagator``: the pretrainer's propagator over ``view_csr``).
Two views give ``z' = P_1 e0`` and ``z'' = P_2 e0``.

The contrastive term (paper eq. 10) on the batch's users, with s the
cosine and the denominator over every user of view 2::

    l_u = -log(exp(s(z'_u, z''_u) / t) / sum_v exp(s(z'_u, z''_v) / t))

and the same over the batch's positive items against every item.
``Views.term`` gives it, weighted by ``ssl_reg``, and its gradients at
the views' final tables; ``lightgcn.bpr_step`` adds it to the BPR loss
(eq. 11). Departure from the paper: every reduction is a mean over the
batch (BPR over the triples, InfoNCE over the users and over the
positives) where eq. 10-11 write sums; that scales the objective by 1/B,
to which Adam is invariant up to its eps.

``info_nce`` runs the whole-table denominator over key chunks of at most
``INFONCE_CHUNK_BYTES`` of logits: the forward pass an online max and
sum of exponentials, the backward pass recomputing each chunk's logits;
each product is one ``torch.mm`` (cuBLAS on the card, float32 under
``pretrain``'s TF32-off precision). No [B, n] logits are held whole.

The table's gradient: each P_v is symmetric as P is, so the gradient is
``P s + P_1 s' + P_2 s''``, three propagations of the rows' gradients
(``s'`` on the batch's rows of view 1; ``s''`` dense, from view 2's
denominators; ``Views.add_grad`` the last two), not autograd over the
table. This module imports nothing of ``models.lightgcn``: the
pretrainer hands ``Views`` its propagator builder.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from gdmcf_torch.utils.profiling import span

# the logits a chunk of ``info_nce`` holds at most: [2048, 131072] float32
INFONCE_CHUNK_BYTES = 1 << 30
# F.normalize's floor on a row's norm
_NORM_EPS = 1e-12


# ---------------------------------------------------------------------------
# views
# ---------------------------------------------------------------------------

def kept_count(nnz: int, ratio: float) -> int:
    """``floor((1 - ratio) * nnz)``: the interactions a view keeps."""
    return int(math.floor((1.0 - ratio) * nnz))


def draw_kept(rng: np.random.Generator, nnz: int, ratio: float
              ) -> np.ndarray:
    """Sorted int64 indices of the stored interactions one view keeps:
    ``kept_count(nnz, ratio)`` of ``range(nnz)``, uniformly without
    replacement (the tail of one permutation from ``rng`` is dropped)."""
    keep = np.ones(nnz, dtype=bool)
    keep[rng.permutation(nnz)[kept_count(nnz, ratio):]] = False
    return np.flatnonzero(keep)


def view_csr(train_csr: sp.spmatrix, kept: np.ndarray) -> sp.csr_matrix:
    """The sub-graph of ``train_csr``'s stored entries at ``kept`` (indices
    into its CSR data, sorted), values and shape kept: both directions of
    a view are this one matrix and its transpose."""
    csr = train_csr.tocsr()
    n_user = csr.shape[0]
    rows = np.repeat(np.arange(n_user, dtype=np.int64),
                     np.diff(csr.indptr))[kept]
    indptr = np.zeros(n_user + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n_user), out=indptr[1:])
    return sp.csr_matrix((csr.data[kept], csr.indices[kept], indptr),
                         shape=csr.shape)


# ---------------------------------------------------------------------------
# InfoNCE over a whole table
# ---------------------------------------------------------------------------

def _unit_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(
        _NORM_EPS)
    return x / norm, norm


def _unit_rows_grad(unit: torch.Tensor, norm: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """The gradient at x of a loss whose gradient at x / |x| is g."""
    return (g - unit * (unit * g).sum(1, keepdim=True)) / norm


def chunk_rows(batch: int) -> int:
    """Key rows a chunk of ``info_nce`` takes at a batch of ``batch``."""
    return max(1, INFONCE_CHUNK_BYTES // (4 * batch))


def info_nce(q: torch.Tensor, keys: torch.Tensor, pos: torch.Tensor,
             temp: float, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """(loss, dq, dkeys, chunks): the InfoNCE of the rows of ``q`` [B, D]
    against all rows of ``keys`` [n, D], row b's positive ``keys[pos[b]]``,
    cosine over ``temp``, the mean over the B rows; its gradients at ``q``
    and at every row of ``keys``; the key chunks of ``chunk`` rows (the
    forward and the backward pass each run every chunk). No graph is
    built."""
    b = q.shape[0]
    q_unit, q_norm = _unit_rows(q)
    k_unit, k_norm = _unit_rows(keys)
    qs = q_unit / temp
    starts = range(0, keys.shape[0], chunk)
    run_max = torch.full((b,), -math.inf, dtype=q.dtype, device=q.device)
    run_sum = torch.zeros(b, dtype=q.dtype, device=q.device)
    for k0 in starts:
        logits = qs @ k_unit[k0:k0 + chunk].T
        new_max = torch.maximum(run_max, logits.amax(1))
        run_sum = run_sum * torch.exp(run_max - new_max) \
            + logits.sub_(new_max[:, None]).exp_().sum(1)
        run_max = new_max
        del logits
    lse = run_max + torch.log(run_sum)
    pos_keys = k_unit[pos]
    loss = (lse - (qs * pos_keys).sum(1)).mean()
    # d loss / d logits = (softmax - onehot(pos)) / B: the softmax over B
    # is exp(logits - lse - log B), each chunk's logits recomputed
    shift = (lse + math.log(b))[:, None]
    d_qs = torch.zeros_like(qs)
    d_unit = torch.empty_like(k_unit)
    for k0 in starts:
        kc = k_unit[k0:k0 + chunk]
        p = (qs @ kc.T).sub_(shift).exp_()
        d_qs.addmm_(p, kc)
        torch.mm(p.T, qs, out=d_unit[k0:k0 + chunk])
        del p
    d_qs.sub_(pos_keys / b)
    # a key that is two rows' positive sums both in one order on every run
    d_unit.index_put_((pos,), qs / -b, accumulate=True)
    dq = _unit_rows_grad(q_unit, q_norm, d_qs / temp)
    dkeys = _unit_rows_grad(k_unit, k_norm, d_unit)
    return loss, dq, dkeys, len(starts)


# ---------------------------------------------------------------------------
# the views on a pretrainer
# ---------------------------------------------------------------------------

class Views:
    """SGL-ED's two views of ``train_csr`` on a BPR pretrainer: their draw
    from its host generator, their operands, their InfoNCE and their
    share of the table's gradient.

    ``build(csr)`` is a view's propagator over its sub-CSR (the
    pretrainer's ``lightgcn.propagator`` at N's layers, format and grid),
    ``reg`` the InfoNCE's weight, ``ratio`` the share of interactions a
    view drops, ``temp`` the temperature. ``kept``: each view's sorted
    int64 indices of the stored interactions it keeps (None before the
    first draw); ``props``: their propagators. ``counts``:
    ``views_drawn`` and ``infonce_chunks`` (the key chunks ``info_nce``
    ran, summed over the steps); ``seconds``: each view's draw and build
    on the host's clock. Spans: ``gdmcf.sgl.views`` (a view's draw and
    build), ``gdmcf.sgl.infonce`` (``term``: both sides' forward and
    backward dispatch and the seeds' puts) and ``gdmcf.sgl.grad``
    (``add_grad``)."""

    def __init__(self, train_csr: sp.spmatrix,
                 build: Callable[[sp.csr_matrix], Callable], reg: float,
                 ratio: float, temp: float):
        if not 0 <= ratio < 1:
            raise ValueError(f"ssl_ratio={ratio}: a view drops a share in "
                             "[0, 1) of the interactions")
        self.csr, self.build = train_csr, build
        self.reg, self.ratio, self.temp = reg, ratio, temp
        self.kept: Optional[Tuple[np.ndarray, ...]] = None
        self.props: Optional[Tuple[Callable, ...]] = None
        self.counts = {"views_drawn": 0, "infonce_chunks": 0}
        self.seconds = []

    def propagator(self, kept: np.ndarray) -> Callable:
        """The view's ``P_v e0``: ``build`` over ``view_csr(csr, kept)``,
        so N_v is normalized on the view's own degrees."""
        return self.build(view_csr(self.csr, kept))

    def draw(self, rng: np.random.Generator) -> None:
        """Draw both views anew from ``rng`` and build their operands."""
        self._put(None, rng)
        self.counts["views_drawn"] += 2

    def put(self, kept: Tuple[np.ndarray, ...]) -> None:
        """Make ``kept`` the views, built anew only where they differ from
        the current ones."""
        if not all(a is b or np.array_equal(a, b)
                   for a, b in zip(kept, self.kept)):
            self._put(kept, None)

    def _put(self, kept, rng) -> None:
        # kept None: each view's edges drawn from rng
        self.props = None   # the old operands go before the new
        got, props = [], []
        for v in range(2):
            t0 = time.perf_counter()
            with span("gdmcf.sgl.views"):
                got.append(draw_kept(rng, self.csr.nnz, self.ratio)
                           if kept is None else kept[v])
                props.append(self.propagator(got[-1]))
            self.seconds.append(time.perf_counter() - t0)
        self.kept, self.props = tuple(got), tuple(props)

    def operands(self) -> Tuple:
        """Each view's (N_v's, N_v^T's) row operands on the device (None
        for the dense N)."""
        return tuple(getattr(p, "operands", None) for p in self.props)

    def term(self, e0: torch.Tensor, users: torch.Tensor, pos: torch.Tensor,
             n_user: int) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """(loss, seeds) at the table ``e0``: ``reg`` times the InfoNCE of
        view 1's rows of ``users`` against all of view 2's users and of
        view 1's rows of the items ``pos`` against all of view 2's items;
        its gradients at view 1's and at view 2's final tables (view 1's
        on the batch's rows, view 2's dense from the denominators). Adds
        the key chunks to ``counts``. No graph is built."""
        with torch.no_grad():
            fu1, fi1 = self.props[0](e0)
            fu2, fi2 = self.props[1](e0)
        with span("gdmcf.sgl.infonce"), torch.no_grad():
            chunk = chunk_rows(users.shape[0])
            loss_u, dq_u, dk_u, c_u = info_nce(fu1[users], fu2, users,
                                               self.temp, chunk)
            loss_i, dq_i, dk_i, c_i = info_nce(fi1[pos], fi2, pos,
                                               self.temp, chunk)
            self.counts["infonce_chunks"] += c_u + c_i
            del fu1, fi1, fu2, fi2
            seed1 = torch.zeros_like(e0)
            seed1.index_put_((users,), self.reg * dq_u, accumulate=True)
            seed1.index_put_((n_user + pos,), self.reg * dq_i,
                             accumulate=True)
            seed2 = torch.cat([dk_u, dk_i]).mul_(self.reg)
        return self.reg * (loss_u + loss_i), (seed1, seed2)

    def add_grad(self, grad: torch.Tensor, seeds) -> None:
        """Add ``P_1 s' + P_2 s''`` of ``term``'s seeds to the table's
        gradient ``grad``, in place: each P_v is symmetric."""
        with span("gdmcf.sgl.grad"), torch.no_grad():
            for prop, s in zip(self.props, seeds):
                grad += torch.cat(prop(s))
