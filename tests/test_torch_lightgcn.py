"""LightGCN normalization and propagation, and the DNNlightGCN backbone, in
the port against the JAX package.

The propagation starts from the JAX package's own raw Xavier tables and is
held to the frozen tables that ``dnn_lightgcn.init`` propagates (its
Pallas SpMM in interpret mode), at rtol 1e-5 / atol 1e-6: both sum the
same float32 terms in another order.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch import compat  # noqa: E402
from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.models import lightgcn as TG  # noqa: E402
from gdmcf_torch.models.backbones import DNNlightGCN  # noqa: E402
from gdmcf_torch.models.registry import build_model  # noqa: E402
from gdmcf_torch.ops.spmm import BlockSparse, HybridSparse  # noqa: E402
from gdmcf_tpu.models import lightgcn as JG  # noqa: E402
from gdmcf_tpu.models.backbones import dnn_lightgcn  # noqa: E402
from gdmcf_tpu.models.layers import xavier_uniform  # noqa: E402
from gdmcf_tpu.ops import spmm as JS  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
N_USER, N_ITEM, LGN_DIM = 70, 150, 64


def interactions(seed=0, n_user=N_USER, n_item=N_ITEM):
    """Power-law-ish binary user x item matrix with an isolated user."""
    rng = np.random.default_rng(seed)
    p = (np.arange(n_item) + 1.0) ** -0.7
    rows, cols = [], []
    for u in range(n_user - 1):
        items = rng.choice(n_item, size=rng.integers(3, 25), replace=False,
                           p=p / p.sum())
        rows += [u] * len(items)
        cols += list(items)
    return sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                         shape=(n_user, n_item))


def t_(a):
    return torch.from_numpy(np.array(a))


def test_normalized_blocks_match_jax():
    r = interactions()
    np.testing.assert_allclose(TG.normalized_bipartite_blocks(r),
                               JG.normalized_bipartite_blocks(r),
                               rtol=1e-7, atol=0)


@pytest.mark.parametrize("degree_sort", [False, True])
def test_normalized_sparse_and_hybrid_match_jax(degree_sort):
    r = interactions(1)
    tb = TG.normalized_bipartite_sparse(r, br=16, bc=32,
                                        degree_sort=degree_sort)
    jb = JG.normalized_bipartite_sparse(r, br=16, bc=32,
                                        degree_sort=degree_sort)
    th = TG.normalized_bipartite_hybrid(r, degree_sort=degree_sort)
    jh = JG.normalized_bipartite_hybrid(r, degree_sort=degree_sort)
    if degree_sort:
        for (tp, jp) in ((tb[1], jb[1]), (th[1], jh[1])):
            for a, b in zip(tp, jp):
                np.testing.assert_array_equal(a, b)
        tb, jb, th, jh = tb[0], jb[0], th[0], jh[0]
    for t_op, j_op in ((tb, jb), (th.tiles, jh.tiles)):
        nb = t_op.n_blocks
        assert nb == int(j_op.row_ptr[-1])
        np.testing.assert_allclose(t_op.blocks[:nb].numpy(),
                                   np.asarray(j_op.blocks)[:nb],
                                   rtol=1e-7, atol=0)
        np.testing.assert_array_equal(
            t_op.block_cols[:nb].numpy(),
            np.asarray(j_op.block_cols).reshape(-1)[:nb])
    np.testing.assert_allclose(th.rem_vals.numpy(), np.asarray(jh.rem_vals),
                               rtol=1e-7, atol=0)
    np.testing.assert_array_equal(th.rem_rows.numpy(),
                                  np.asarray(jh.rem_rows))


def jax_raw_tables(key):
    """The raw tables dnn_lightgcn.init draws before propagating."""
    k4 = jax.random.split(key, 4)[3]
    emb = np.asarray(xavier_uniform(k4, (N_USER + N_ITEM, LGN_DIM)))
    return t_(emb[:N_USER]), t_(emb[N_USER:])


# the Pallas interpreter takes seconds per product: one layer for the
# sparse formats (the port's two-layer chain is held to the dense one below)
@pytest.mark.parametrize("fmt,layers", [("hybrid", 1), ("sparse", 1),
                                        ("dense", 2)])
def test_propagation_matches_jax_frozen_tables(fmt, layers):
    r = interactions(2)
    key = jax.random.PRNGKey(3)
    def rows(u, i, a, k):
        return TG.propagate_rows(u, i, a.fwd_rows, a.t_rows, k)

    if fmt == "hybrid":
        j_op = (JG.normalized_bipartite_hybrid(r), True)
        t_op = TG.normalized_bipartite_hybrid(r)
        prop = rows
    elif fmt == "sparse":
        j_op = (JG.normalized_bipartite_sparse(r, br=16, bc=32), True)
        t_op = TG.normalized_bipartite_sparse(r, br=16, bc=32)
        prop = rows
    else:
        j_op, t_op = None, t_(TG.normalized_bipartite_blocks(r))
        prop = TG.propagate
    dense_n = JG.normalized_bipartite_blocks(r) if fmt == "dense" else None
    model = dnn_lightgcn([N_ITEM, 8], [8, N_ITEM], 10, N_USER, N_ITEM,
                         lgn_layers=layers, norm_adj=dense_n,
                         sparse_adj=j_op)
    p = model.init(key)
    u, i = prop(*jax_raw_tables(key), t_op, layers)
    np.testing.assert_allclose(u.numpy(), np.asarray(p["frozen_lgn_user"]),
                               **TOL)
    np.testing.assert_allclose(i.numpy(), np.asarray(p["frozen_lgn_item"]),
                               **TOL)


def test_hybrid_propagation_matches_dense_in_the_port():
    r = interactions(4)
    g = torch.Generator().manual_seed(0)
    u0, i0 = DNNlightGCN.draw_lgn_table(N_USER, N_ITEM, LGN_DIM, g)
    ud, id_ = TG.propagate(u0, i0, t_(TG.normalized_bipartite_blocks(r)), 2)
    h = TG.normalized_bipartite_hybrid(r)
    uh, ih = TG.propagate_rows(u0, i0, h.fwd_rows, h.t_rows, 2)
    torch.testing.assert_close(uh, ud, **TOL)
    torch.testing.assert_close(ih, id_, **TOL)


@pytest.mark.parametrize("force_hybrid", [False, True])
def test_registry_switch_and_backbone_forward_match_jax(monkeypatch,
                                                        force_hybrid):
    """build_model takes the hybrid operand exactly when the dense N would
    pass _DENSE_LIMIT_BYTES; the forward with bridged weights matches the
    JAX apply."""
    r = interactions(5)
    if force_hybrid:
        monkeypatch.setattr(TG, "_DENSE_LIMIT_BYTES", 0)
    cfg = TConfig(backbone="lightGCN", dims=[16], emb_size=10, device="cpu")
    model = build_model(cfg, N_USER, N_ITEM, train_csr=r,
                        generator=torch.Generator().manual_seed(1),
                        device="cpu")
    assert isinstance(model, DNNlightGCN)
    # the hybrid and dense operands propagate the same tables
    g = torch.Generator().manual_seed(1)
    u0, i0 = DNNlightGCN.draw_lgn_table(N_USER, N_ITEM, LGN_DIM, g)
    ud, _ = TG.propagate(u0, i0, t_(TG.normalized_bipartite_blocks(r)), 2)
    torch.testing.assert_close(model.frozen_lgn_user, ud, **TOL)

    jm = dnn_lightgcn(cfg.in_dims(N_ITEM), cfg.out_dims(N_ITEM), 10, N_USER,
                      N_ITEM, norm_adj=JG.normalized_bipartite_blocks(r))
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    model.load_state_dict({k: t_(v) for k, v in
                           compat.state_dict_from_jax_params(jp).items()})
    rng = np.random.default_rng(6)
    x = (rng.random((7, N_ITEM)) < 0.1).astype(np.float32)
    t = rng.integers(0, 5, 7)
    index = rng.integers(0, N_USER, 7)
    want, _ = jm.apply(jp, jnp.asarray(x), jnp.asarray(t), None,
                       index=jnp.asarray(index))
    model.eval()
    with torch.no_grad():
        got, closs = model(t_(x), t_(t), None, index=t_(index))
    assert closs is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_operand_types():
    r = interactions(7)
    assert isinstance(TG.normalized_bipartite_sparse(r), BlockSparse)
    h = TG.normalized_bipartite_hybrid(r)
    assert isinstance(h, HybridSparse) and h.device.type == "cpu"
    assert isinstance(JS.to_hybrid(r.tocoo()), JS.HybridSparse)


def graph_case(case):
    """(interactions, whether the mirrors degree-sort) of a graph case."""
    if case == "empty_rows_and_cols":
        r = interactions(8).tolil()
        r[3:9, :] = 0
        r[:, 40:55] = 0
        return r.tocsr(), False
    if case == "counts":
        r = interactions(9)
        r.data = np.random.default_rng(9).integers(
            1, 5, r.nnz).astype(np.float32)
        return r, False
    return interactions(10), case == "degree_sort"


@pytest.mark.parametrize("br,bc", [(8, 16), (16, 32)])
@pytest.mark.parametrize("case", ["ragged", "empty_rows_and_cols",
                                  "degree_sort", "counts"])
def test_row_operands_equal_the_mirrors_operands(case, br, bc):
    """normalized_row_operands builds no tile and gives, field for field,
    the row operands of both tile formats at the same grid (70 x 150 is a
    multiple of neither grid). With degree_sort the mirrors permute N; the
    function gets the interactions permuted the same way."""
    r, degree_sort = graph_case(case)
    hybrid = TG.normalized_bipartite_hybrid(r, br=br, bc=bc,
                                            degree_sort=degree_sort)
    block = TG.normalized_bipartite_sparse(r, br=br, bc=bc,
                                           degree_sort=degree_sort)
    if degree_sort:
        (hybrid, (rp, cp)), block = hybrid, block[0]
        r = r.tocsr()[rp][:, cp]
    fwd, t = TG.normalized_row_operands(r, br, bc)
    assert fwd.n_out == -(-N_USER // br) * br
    assert t.n_out == -(-N_ITEM // bc) * bc
    for mirror in (hybrid, block):
        for got, want in ((fwd, mirror.fwd_rows), (t, mirror.t_rows)):
            for name in got._TENSORS:
                assert torch.equal(getattr(got, name),
                                   getattr(want, name)), name
            assert (got.n_part, got.transpose, got.n_out) == (
                want.n_part, want.transpose, want.n_out)


def refuse(*a, **k):
    raise AssertionError("a run path built tiles")


@pytest.mark.parametrize("path", ["pretrainer_hybrid", "pretrainer_block",
                                  "pretrain_above_the_limit",
                                  "backbone_above_the_limit"])
def test_no_run_path_builds_a_tile(monkeypatch, path):
    """With ``to_hybrid`` and ``to_block_sparse`` refusing, the pretrainer
    on either sparse form takes a step, pretrain above the dense limit
    trains, and the registry's lightGCN backbone above it runs a forward
    pass."""
    monkeypatch.setattr(TG, "to_hybrid", refuse)
    monkeypatch.setattr(TG, "to_block_sparse", refuse)
    r = interactions(11)
    kw = dict(n_layers=2, latent_dim=8, batch_size=16, seed=1,
              block_size=16, device="cpu")
    if path.startswith("pretrainer"):
        pt = TG.BPRPretrainer(
            r, sparse="hybrid" if path == "pretrainer_hybrid" else True, **kw)
        assert pt.operands() is not None
        assert np.isfinite(pt.loss_total(pt.steps(1)))
        return
    monkeypatch.setattr(TG, "_DENSE_LIMIT_BYTES", 0)
    if path == "pretrain_above_the_limit":
        res = TG.pretrain(r, r, epochs=1, steps_per_epoch=2, sparse=None,
                          evaluate=False, log=lambda *a: None, **kw)
        assert np.isfinite(res.final_user).all()
        return
    cfg = TConfig(backbone="lightGCN", dims=[16], emb_size=10, device="cpu")
    model = build_model(cfg, N_USER, N_ITEM, train_csr=r,
                        generator=torch.Generator().manual_seed(1),
                        device="cpu")
    model.eval()
    x = torch.from_numpy(r[:5].toarray())
    with torch.no_grad():
        out, _ = model(x, torch.zeros(5, dtype=torch.long), None,
                       index=torch.arange(5))
    assert torch.isfinite(out).all()
