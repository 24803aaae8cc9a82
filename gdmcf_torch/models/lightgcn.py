"""LightGCN: the normalized adjacency, propagation and BPR pretraining.

Port of the JAX package's ``models/lightgcn.py``: with R the user x item
interactions, N = D_u^{-1/2} R D_i^{-1/2}, one layer is
``u' = N @ e_item, i' = N^T @ e_user``, and the final tables are the mean
over layers 0..K. ``normalized_operand`` gives N to the propagator, the
pretrainer and the lightGCN backbone: dense, or (N's, N^T's) row operands,
which run on ``ops/spmm`` (the CUDA kernel for CUDA tensors, one launch a
product, differentiable through ``ops.spmm.spmm_op``, whose backward pass
is one launch in the other direction). No run path builds a tile: only
the mirrors ``normalized_bipartite_sparse`` / ``_hybrid`` build the JAX
tile formats, for the tests and ``chip_smoke.py``.

``pretrain`` is the reference pretrainer's recipe (BPR with L2 on the
layer-0 rows, Adam, ranking evaluation with natural-log NDCG), its steps
run by ``BPRPretrainer`` (which a caller can also step alone; each step,
``bpr_step``, takes the table's gradient as the propagation of the
batch's row gradients, not by autograd over the tables), with the
JAX package's draws: one ``np.random.default_rng(seed)`` picks each batch's
users and then the seed of ``NativeCSR.sample_bpr``, so at equal initial
tables the port trains on the JAX package's triples. The Adam update is the
port's AdamW kernel (``ops/fused_adamw``, K1) with float32 moments and no
weight decay, which is the JAX package's Adam (b1 0.9, b2 0.999, eps 1e-8
added after the square root). With ``ssl_reg > 0`` the pretrainer and
``pretrain`` train SGL-ED instead (``models.sgl``: two edge-dropped views
and a whole-table InfoNCE on the same encoder).
"""

from __future__ import annotations

import copy
import os
import warnings
from collections import deque
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from gdmcf_torch import resolve_device
from gdmcf_torch.data.native import NativeCSR
from gdmcf_torch.models import sgl as SGL
from gdmcf_torch.models.layers import xavier_uniform
from gdmcf_torch.ops.fused_adamw import (FusedAdamWState, fused_adamw_apply,
                                         fused_adamw_init)
from gdmcf_torch.ops.metrics import lightgcn_topn_metrics
from gdmcf_torch.ops.spmm import (RowOperand, degree_sort_permutation,
                                  row_operands, spmm_op, to_block_sparse,
                                  to_hybrid)
from gdmcf_torch.ops.topk import chunked_topk
from gdmcf_torch.utils.profiling import span

# a dense [n_user, n_item] f32 N above this many bytes switches the
# lightGCN backbone and pretraining to a sparse operand, and turns off
# pretraining's dense ranking evaluation
_DENSE_LIMIT_BYTES = 2 << 30


def _inv_sqrt_degrees(r, eps: float):
    deg_u = np.asarray(r.sum(axis=1)).ravel()
    deg_i = np.asarray(r.sum(axis=0)).ravel()
    du = np.power(deg_u + eps, -0.5)
    di = np.power(deg_i + eps, -0.5)
    du[np.isinf(du)] = 0.0
    di[np.isinf(di)] = 0.0
    return du, di


def normalized_bipartite_blocks(train_csr: sp.spmatrix,
                                eps: float = 1e-9) -> np.ndarray:
    """N as a dense [n_user, n_item] float32 matrix."""
    r = train_csr.astype(np.float32).toarray()
    du, di = _inv_sqrt_degrees(r, eps)
    return (r * du[:, None]) * di[None, :]


def _normalized_sparse_n(train_csr: sp.spmatrix, eps: float,
                         degree_sort: bool):
    r = train_csr.tocsr().astype(np.float32)
    du, di = _inv_sqrt_degrees(r, eps)
    n = sp.diags(du) @ r @ sp.diags(di)
    perms = None
    if degree_sort:
        row_perm, col_perm = degree_sort_permutation(n)
        n = n.tocsr()[row_perm][:, col_perm]
        perms = (row_perm, col_perm)
    return n, perms


def normalized_row_operands(train_csr: sp.spmatrix, br: int, bc: int,
                            eps: float = 1e-9
                            ) -> Tuple[RowOperand, RowOperand]:
    """(N's, N^T's) row operands on the CPU, of N's float32 CSR padded to
    multiples of ``br`` rows and ``bc`` columns: the mirrors' ``fwd_rows``
    / ``t_rows`` at that grid, tensor for tensor, without tiles."""
    coo = _normalized_sparse_n(train_csr, eps, False)[0].tocoo()
    shape = (-(-coo.shape[0] // br) * br, -(-coo.shape[1] // bc) * bc)
    return row_operands(sp.csr_matrix(
        (coo.data.astype(np.float32), (coo.row, coo.col)), shape=shape))


def normalized_operand(train_csr: sp.spmatrix, sparse,
                       block_size: int = 128,
                       block_rows: Optional[int] = None):
    """N on the CPU: dense ([n_user, n_item] float32) for ``sparse=False``,
    else ``normalized_row_operands`` over ``block_rows or 8`` (``"hybrid"``)
    or ``block_rows or block_size`` (``True``) rows x ``block_size``.
    ``None`` is ``True`` once the dense N would pass ``_DENSE_LIMIT_BYTES``."""
    if sparse not in (None, True, False, "hybrid"):   # a misspelt name
        raise ValueError(f"sparse={sparse!r}: expected None, True, False, "
                         "or 'hybrid'")
    if sparse is None:
        n_user, n_item = train_csr.shape
        sparse = n_user * n_item * 4 > _DENSE_LIMIT_BYTES
    if not sparse:
        return torch.from_numpy(normalized_bipartite_blocks(train_csr))
    br = block_rows or (8 if sparse == "hybrid" else block_size)
    return normalized_row_operands(train_csr, br, block_size)


def normalized_bipartite_sparse(train_csr: sp.spmatrix, br: int = 128,
                                bc: int = 128, eps: float = 1e-9,
                                max_bytes: int = 8 << 30,
                                degree_sort: bool = False):
    """N as ONE BlockSparse (its ``t_rows`` serve N^T), the JAX format's
    mirror; with ``degree_sort`` also returns (row_perm, col_perm)."""
    n, perms = _normalized_sparse_n(train_csr, eps, degree_sort)
    n_bs = to_block_sparse(n, br, bc, max_bytes)
    return (n_bs, perms) if degree_sort else n_bs


def normalized_bipartite_hybrid(train_csr: sp.spmatrix, br: int = 8,
                                bc: int = 128, min_fill: int = 4,
                                eps: float = 1e-9, max_bytes: int = 8 << 30,
                                degree_sort: bool = False):
    """N as a HybridSparse (tiles + COO remainder, and the row operands
    over all of its nonzeros), the JAX format's mirror."""
    n, perms = _normalized_sparse_n(train_csr, eps, degree_sort)
    h = to_hybrid(n, br=br, bc=bc, min_fill=min_fill, max_bytes=max_bytes)
    return (h, perms) if degree_sort else h


def _layers(e_user, e_item, n_layers, fwd, bwd):
    n_user, n_item = e_user.shape[0], e_item.shape[0]
    us, its = [e_user], [e_item]
    u, i = e_user, e_item
    for _ in range(n_layers):
        u, i = fwd(i)[:n_user], bwd(u)[:n_item]
        us.append(u)
        its.append(i)
    return sum(us) / (n_layers + 1), sum(its) / (n_layers + 1)


def propagate(e_user: torch.Tensor, e_item: torch.Tensor,
              n_mat: torch.Tensor, n_layers: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-layer propagation on the dense N, mean over layers 0..K."""
    return _layers(e_user, e_item, n_layers, lambda i: n_mat @ i,
                   lambda u: n_mat.T @ u)


def propagate_rows(e_user: torch.Tensor, e_item: torch.Tensor,
                   fwd: RowOperand, t: RowOperand, n_layers: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``propagate`` on the row operands of N and N^T. Differentiable in
    both tables: each product's backward pass is one product on the other
    operand."""
    return _layers(e_user, e_item, n_layers, lambda i: spmm_op(fwd, t, i),
                   lambda u: spmm_op(t, fwd, u))


# ---------------------------------------------------------------------------
# BPR pretraining
# ---------------------------------------------------------------------------

def bpr_loss(users_emb: torch.Tensor, pos_emb: torch.Tensor,
             neg_emb: torch.Tensor, user0: torch.Tensor, pos0: torch.Tensor,
             neg0: torch.Tensor, batch_size: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BPR loss, L2 term): softplus(neg - pos score) averaged, and half
    the squared norms of the layer-0 rows over the batch size."""
    reg = 0.5 * ((user0 ** 2).sum() + (pos0 ** 2).sum()
                 + (neg0 ** 2).sum()) / batch_size
    pos_scores = (users_emb * pos_emb).sum(dim=1)
    neg_scores = (users_emb * neg_emb).sum(dim=1)
    loss = torch.nn.functional.softplus(neg_scores - pos_scores).mean()
    return loss, reg


def _choose_users(rng: np.random.Generator, n_user: int,
                  batch_size: int) -> np.ndarray:
    """Sorted user sample (with replacement only when the population is
    smaller than the batch), shared by both BPR samplers."""
    if n_user < batch_size:
        users = rng.integers(0, n_user, batch_size)
    else:
        users = rng.choice(n_user, batch_size, replace=False)
    users.sort()
    return users


def sample_bpr_batch(rng: np.random.Generator, train_csr: sp.spmatrix,
                     batch_size: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side (user, pos, neg) triples with rejection-sampled negatives,
    every draw from ``rng``: the plain per-user loop. ``pretrain`` samples
    with ``NativeCSR.sample_bpr`` instead (same semantics, other draws)."""
    n_user, n_item = train_csr.shape
    deg = np.diff(train_csr.indptr)
    if deg.size and int(deg.max()) >= n_item:
        raise ValueError(
            "BPR negative sampling impossible: some user interacted with "
            f"all {n_item} items (the rejection loop would never exit)")
    users = _choose_users(rng, n_user, batch_size)
    indptr, indices = train_csr.indptr, train_csr.indices
    pos = np.empty(batch_size, dtype=np.int64)
    neg = np.empty(batch_size, dtype=np.int64)
    for k, u in enumerate(users):
        items = indices[indptr[u]:indptr[u + 1]]
        if len(items) == 0:
            pos[k] = rng.integers(n_item)
            neg[k] = rng.integers(n_item)
            continue
        pos[k] = rng.choice(items)
        iset = set(items.tolist())
        while True:
            cand = rng.integers(n_item)
            if cand not in iset:
                neg[k] = cand
                break
    return users, pos, neg


class LightGCNResult(NamedTuple):
    final_user: np.ndarray
    final_item: np.ndarray
    initial_user: np.ndarray
    initial_item: np.ndarray


Propagator = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def propagator(train_csr: sp.spmatrix, n_layers: int, sparse,
               block_size: int = 128, block_rows: Optional[int] = None,
               device=None) -> Propagator:
    """``prop(e0) -> (final_user, final_item)`` over the stacked table
    ``e0 = [e_user; e_item]``, differentiable, on ``normalized_operand``'s
    N (``sparse``, ``block_size`` and ``block_rows`` as there). The sparse
    form's (N's, N^T's) row operands on the device are ``prop.operands``."""
    dev = resolve_device(device)
    n_user = train_csr.shape[0]
    a = normalized_operand(train_csr, sparse, block_size, block_rows)
    if isinstance(a, torch.Tensor):
        n_mat = a.to(dev)
        return lambda e0: propagate(e0[:n_user], e0[n_user:], n_mat,
                                    n_layers)
    fwd, t = (op.to(dev) for op in a)

    def prop(e0):
        return propagate_rows(e0[:n_user], e0[n_user:], fwd, t, n_layers)

    prop.operands = (fwd, t)
    return prop


def initial_table(n_rows: int, dim: int, seed: int, device=None
                  ) -> torch.Tensor:
    """The Xavier-uniform [n_user + n_item, dim] table ``pretrain`` starts
    from, drawn by a CPU ``torch.Generator`` seeded with seed and then
    moved: a seed gives the same table on every device, so a run on the
    CPU starts where the same run on the card does."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return xavier_uniform((n_rows, dim), gen).to(dev)


def bpr_step(e0: torch.Tensor, opt_state: FusedAdamWState, prop: Propagator,
             batch: torch.Tensor, n_user: int, lr: float, decay: float,
             views: "Optional[SGL.Views]" = None
             ) -> Tuple[FusedAdamWState, torch.Tensor]:
    """One BPR step in place on the leaf ``e0``: propagate, BPR loss plus
    ``decay`` times the L2 term on the batch's layer-0 rows, the gradient,
    and the Adam update (one AdamW kernel launch on CUDA). ``batch``:
    [3, B] int64 (users, positive and negative items) on e0's device.
    Returns the state and the loss, left on the device.

    Autograd runs over the batch's rows alone. The propagation is
    ``final = P e0`` with P the mean of the powers 0..K of the symmetric
    A = [[0, N], [N^T, 0]], so P is symmetric and the table's gradient is
    ``P s``: the same propagation run on s, the loss's gradient at the
    final tables (zero outside the batch's rows), plus the L2 term's at
    the batch's layer-0 rows. No table-sized gradient of a slice, a gather
    or the layer mean is formed.

    ``views`` (SGL-ED's, ``models.sgl.Views``) adds their weighted
    InfoNCE to the loss and ``P_1 s' + P_2 s''`` to the gradient
    (``Views.term``, ``Views.add_grad``); None is the BPR step alone."""
    users, pos, neg = batch
    rows = (users, n_user + pos, n_user + neg)
    with torch.no_grad():
        fu, fi = prop(e0)
        leaves = [t.requires_grad_() for t in (
            fu[users], fi[pos], fi[neg], *(e0[r] for r in rows))]
    loss, reg = bpr_loss(*leaves, users.shape[0])
    total = loss + decay * reg
    grads = torch.autograd.grad(total, leaves)
    # one accumulating put a gather, as autograd's backward of each gather
    # takes: a row in the batch twice (a positive that is also another
    # triple's negative) sums its gradients in one order on every run, by
    # a sort on CUDA (index_add_'s float atomics would not), and serially
    # on the CPU up to 32768 elements a put (above, the CPU adds by float
    # atomics across threads, so one put of all three would not)
    seed = torch.zeros_like(e0)
    for r, g in zip(rows, grads[:3]):
        seed.index_put_((r,), g, accumulate=True)
    if views is not None:
        del fu, fi
        ssl_loss, view_seeds = views.term(e0, users, pos, n_user)
    with span("gdmcf.bpr.grad"), torch.no_grad():
        grad = torch.cat(prop(seed))
        for r, g in zip(rows, grads[3:]):
            grad.index_put_((r,), g, accumulate=True)
    if views is not None:
        views.add_grad(grad, view_seeds)
        total = total.detach() + ssl_loss
    opt_state = fused_adamw_apply({"e0": e0}, {"e0": grad}, opt_state,
                                  lr=lr)
    return opt_state, total.detach()


def _host_copy(t: torch.Tensor) -> np.ndarray:
    # a copy even on the CPU: e0 is updated in place afterwards
    return t.detach().to("cpu", copy=True).numpy()


class PretrainerState(NamedTuple):
    """A saved start of a ``BPRPretrainer``: host copies of the table, the
    moments and K1's count, the host generator's state, the steps taken
    and, with SGL views, each view's kept-edge indices (never written in
    place, so held, not copied)."""

    e0: np.ndarray
    mu: np.ndarray
    nu: np.ndarray
    count: np.ndarray
    rng: dict
    n_steps: int
    views: Optional[Tuple[np.ndarray, ...]] = None


class BPRPretrainer:
    """BPR pretraining one step at a time: what ``pretrain`` runs, and what
    a caller steps, puts back to a saved start and asks for its triples.

    Holds the table ``e0`` (a leaf updated in place), K1's state with
    float32 moments, the propagator (``sparse``, ``block_size`` and
    ``block_rows`` choose ``normalized_operand``'s dense or sparse N and
    padded grid, and nothing more), the ``NativeCSR`` it samples from and
    the host generator ``np.random.default_rng(seed)``, which draws each
    step's users (``_choose_users``) and then the seed of ``sample_bpr``.

    ``steps(n)`` runs n steps and returns their losses, left on the
    device; ``loss_total`` fetches their sum. ``state()`` / ``restore``
    save and put back the table, the moments, K1's count and the
    generator. ``recent(n)`` returns the triples of the last n steps
    (at most ``keep_batches`` are kept). Spans (``utils.profiling.span``,
    off unless a profiler records): ``gdmcf.bpr.sample`` (the users and
    ``sample_bpr``), ``gdmcf.bpr.feed`` (the stack, pin and copy),
    ``gdmcf.bpr.step`` (``bpr_step``'s dispatch), within it
    ``gdmcf.bpr.grad`` (the propagation of the rows' gradients),
    ``gdmcf.bpr.loss_fetch``.
    ``n_steps`` counts the steps trained on since construction or the
    restored start; ``operands()`` gives the row operands of N and N^T
    the products run on (None for the dense N).

    ``ssl_reg > 0`` makes the steps SGL-ED's (Wu et al., SIGIR 2021):
    ``sgl`` is then a ``models.sgl.Views`` over the graph, ``ssl_ratio``
    the share of interactions a view drops and ``ssl_temp`` the InfoNCE's
    temperature; its two views are drawn from the host generator at
    construction and again by ``redraw_views()`` (``pretrain`` calls it at
    each later epoch's start), ``views()`` gives their kept-edge indices,
    and ``state()`` / ``restore`` carry them too. ``ssl_reg == 0`` builds
    no view and draws nothing for one (``sgl`` None).
    """

    def __init__(self, train_csr: sp.spmatrix, n_layers: int = 3,
                 latent_dim: int = 64, batch_size: int = 1024,
                 lr: float = 0.005, decay: float = 1e-4, seed: int = 0,
                 sparse: "bool | str | None" = None, block_size: int = 128,
                 block_rows: Optional[int] = None, device=None,
                 init_table: Optional[np.ndarray] = None,
                 keep_batches: int = 8, ssl_reg: float = 0.0,
                 ssl_ratio: float = 0.1, ssl_temp: float = 0.2):
        dev = self.device = resolve_device(device)
        self.n_user, self.n_item = train_csr.shape
        self.prop = propagator(train_csr, n_layers, sparse, block_size,
                               block_rows, dev)
        shape = (self.n_user + self.n_item, latent_dim)
        if init_table is None:
            e0 = initial_table(shape[0], latent_dim, seed, dev)
        else:
            if tuple(np.shape(init_table)) != shape:
                raise ValueError(f"init_table shape {np.shape(init_table)} "
                                 f"!= {shape}")
            e0 = torch.tensor(np.asarray(init_table, np.float32), device=dev)
        self.e0 = e0.requires_grad_(True)
        self.opt_state = fused_adamw_init({"e0": e0}, torch.float32)
        self.rng = np.random.default_rng(seed)
        self.batch_size, self.lr, self.decay = batch_size, lr, decay
        # BPR consumes membership, so count-valued cells binarize here
        self.ncsr = NativeCSR.from_scipy(train_csr, strict=False)
        self._batches = deque(maxlen=keep_batches)
        self.n_steps = 0
        self.sgl = None
        if ssl_reg > 0:
            self.sgl = SGL.Views(
                train_csr, lambda csr: propagator(
                    csr, n_layers, sparse, block_size, block_rows, dev),
                ssl_reg, ssl_ratio, ssl_temp)
            self.redraw_views()

    def steps(self, n: int) -> torch.Tensor:
        """Run ``n`` BPR steps; returns their [n] losses on the device."""
        losses = []
        for _ in range(n):
            with span("gdmcf.bpr.sample"):
                users = _choose_users(self.rng, self.n_user, self.batch_size)
                pos, neg = self.ncsr.sample_bpr(
                    users, int(self.rng.integers(2 ** 62)))
            with span("gdmcf.bpr.feed"):
                host = np.stack([users, pos, neg]).astype(np.int64)
                batch = torch.from_numpy(host)
                if self.device.type == "cuda":
                    # a copy from pageable memory would wait for the
                    # stream: pinned and non-blocking, the host samples
                    # the next batch while the device runs this step
                    batch = batch.pin_memory().to(self.device,
                                                  non_blocking=True)
            with span("gdmcf.bpr.step"):
                # no views: bpr_step's seven arguments alone, as code that
                # wraps the BPR step calls it
                views = () if self.sgl is None else (self.sgl,)
                self.opt_state, loss = bpr_step(
                    self.e0, self.opt_state, self.prop, batch, self.n_user,
                    self.lr, self.decay, *views)
            losses.append(loss)
            self._batches.append(host)
            self.n_steps += 1
        return torch.stack(losses) if losses else torch.zeros(
            0, device=self.device)

    def loss_total(self, losses: torch.Tensor) -> float:
        """The sum of ``steps``' losses, fetched to the host."""
        with span("gdmcf.bpr.loss_fetch"):
            return float(losses.sum())

    def recent(self, n: int) -> np.ndarray:
        """The [n, 3, B] int64 (user, positive, negative) triples of the
        last ``n`` steps, oldest first."""
        if not 0 <= n <= len(self._batches):
            raise ValueError(f"{n} steps asked for; {len(self._batches)} "
                             "kept")
        kept = list(self._batches)[len(self._batches) - n:]
        return np.stack(kept) if kept else np.zeros(
            (0, 3, self.batch_size), np.int64)

    def redraw_views(self) -> None:
        """Draw both SGL views anew from the host generator and build their
        operands on the device."""
        if self.sgl is None:
            raise ValueError("no SGL views to redraw: ssl_reg is 0")
        self.sgl.draw(self.rng)

    def views(self) -> Optional[Tuple[np.ndarray, ...]]:
        """Each SGL view's sorted int64 indices of the stored interactions
        it keeps; None without views."""
        return None if self.sgl is None else self.sgl.kept

    def state(self) -> PretrainerState:
        opt = self.opt_state
        return PretrainerState(
            _host_copy(self.e0), _host_copy(opt.mu["e0"]),
            _host_copy(opt.nu["e0"]), _host_copy(opt.count),
            copy.deepcopy(self.rng.bit_generator.state), self.n_steps,
            self.views())

    def restore(self, start: PretrainerState) -> None:
        """Put the table, the moments, K1's count, the generator and the
        views back to ``start``, in place (the views' operands are rebuilt
        only when their kept edges differ from the current ones); the kept
        triples are dropped."""
        if (start.views is None) != (self.sgl is None):
            raise ValueError("the saved start and this pretrainer differ in "
                             "having SGL views")
        if start.views is not None:
            self.sgl.put(start.views)
        opt = self.opt_state
        with torch.no_grad():
            self.e0.copy_(torch.from_numpy(start.e0))
            opt.mu["e0"].copy_(torch.from_numpy(start.mu))
            opt.nu["e0"].copy_(torch.from_numpy(start.nu))
        self.opt_state = opt._replace(
            count=torch.tensor(start.count, device=self.device))
        self.rng.bit_generator.state = copy.deepcopy(start.rng)
        self._batches.clear()
        self.n_steps = start.n_steps

    def operands(self) -> Optional[Tuple[RowOperand, RowOperand]]:
        """(N's, N^T's) row operand on the device; None for the dense N."""
        return getattr(self.prop, "operands", None)

    def tables(self) -> LightGCNResult:
        """The final (propagated) and initial tables, on the host."""
        with torch.no_grad():
            fu, fi = self.prop(self.e0)
        return LightGCNResult(_host_copy(fu), _host_copy(fi),
                              _host_copy(self.e0[:self.n_user]),
                              _host_copy(self.e0[self.n_user:]))


def pretrain(train_csr: sp.spmatrix, test_csr: sp.spmatrix,
             n_layers: int = 3, latent_dim: int = 64, epochs: int = 30,
             batch_size: int = 1024, lr: float = 0.005, decay: float = 1e-4,
             k: int = 10, seed: int = 0, log=print,
             sparse: "bool | str | None" = None, block_size: int = 128,
             block_rows: Optional[int] = None, evaluate: bool = True,
             steps_per_epoch: Optional[int] = None, device=None,
             init_table: Optional[np.ndarray] = None, ssl_reg: float = 0.0,
             ssl_ratio: float = 0.1, ssl_temp: float = 0.2
             ) -> LightGCNResult:
    """The reference pretrainer's loop: Adam and BPR, then per epoch the
    Recall/Precision/NDCG/MAP@k evaluation; returns the four tables of
    the epoch with the best NDCG (the reference saves them as .pt files).
    Each epoch is ``steps_per_epoch`` steps of one ``BPRPretrainer``.

    ``sparse``, ``block_size`` and ``block_rows`` choose
    ``normalized_operand``'s dense or sparse N and padded grid, and nothing
    more (``None``: sparse once the dense [n_user, n_item] N would exceed
    ``_DENSE_LIMIT_BYTES``). ``evaluate=False`` skips the evaluation, which
    is turned off with a warning above that limit (the score matrix is as
    large), and returns the final tables. ``steps_per_epoch`` defaults to
    the reference's budget ``nnz // batch_size``.

    Runs on ``cuda`` unless ``device`` says otherwise. ``init_table``: the
    [n_user + n_item, latent_dim] table to start from (numpy, copied); by
    default ``initial_table(..., seed)``. Dense products and the scores
    run in float32 with TF32 off.

    ``ssl_reg > 0`` trains SGL-ED (``BPRPretrainer``'s ``ssl_*``): the
    views drawn at construction serve epoch 0, and each later epoch starts
    by drawing two new ones.
    """
    from gdmcf_torch.train.trainer import matmul_precision

    dev = resolve_device(device)
    n_user, n_item = train_csr.shape
    dense_bytes = n_user * n_item * 4
    if evaluate and dense_bytes > _DENSE_LIMIT_BYTES:
        warnings.warn(
            f"pretrain: disabling the dense ranking eval at {n_user} x "
            f"{n_item} (score matrix alone would be "
            f"{dense_bytes / 2**30:.1f} GiB); returning final (not "
            "best-NDCG) embeddings", stacklevel=2)
        evaluate = False
    pt = BPRPretrainer(train_csr, n_layers, latent_dim, batch_size, lr,
                       decay, seed, sparse, block_size, block_rows, dev,
                       init_table, keep_batches=0, ssl_reg=ssl_reg,
                       ssl_ratio=ssl_ratio, ssl_temp=ssl_temp)
    if steps_per_epoch is None:
        steps_per_epoch = max(int(train_csr.nnz) // batch_size, 1)
    if evaluate:
        train_mask = torch.from_numpy(
            train_csr.astype(np.float32).toarray() > 0).to(dev)
        test_gt = torch.from_numpy(
            test_csr.astype(np.float32).toarray()).to(dev)

    best_ndcg, best = -1.0, None
    with matmul_precision(tf32=False):
        for epoch in range(epochs):
            if epoch and ssl_reg > 0:
                pt.redraw_views()
            # the losses stay on the device: one fetch per epoch
            total = pt.loss_total(pt.steps(steps_per_epoch))
            if not evaluate:
                log(f"epoch {epoch}: loss {total / steps_per_epoch:.4f}")
                continue
            with torch.no_grad():
                fu, fi = pt.prop(pt.e0)
                scores = (fu @ fi.T).masked_fill_(train_mask, float("-inf"))
                _, pred = chunked_topk(scores, k)
            # the reference pretrainer's protocol: natural-log NDCG, MAP@K,
            # means over test users only
            recall, precision, ndcg, map_k = lightgcn_topn_metrics(
                test_gt, pred, k)
            log(f"epoch {epoch}: loss {total / steps_per_epoch:.4f} "
                f"recall@{k} {recall:.4f} precision@{k} {precision:.4f} "
                f"ndcg@{k} {ndcg:.4f} map@{k} {map_k:.4f}")
            if ndcg > best_ndcg:
                best_ndcg = ndcg
                best = LightGCNResult(_host_copy(fu), _host_copy(fi),
                                      _host_copy(pt.e0[:n_user]),
                                      _host_copy(pt.e0[n_user:]))
        if best is None:   # evaluate=False: the final tables
            best = pt.tables()
    return best


def save_embeddings(result: LightGCNResult, out_dir: str) -> None:
    """Write the four tables to ``out_dir/lightgcn_embeddings.npz`` (the
    reference saves the same contents as .pt files)."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "lightgcn_embeddings.npz"),
             final_user_Embed=result.final_user,
             final_item_Embed=result.final_item,
             initial_user_Embed=result.initial_user,
             initial_item_Embed=result.initial_item)
