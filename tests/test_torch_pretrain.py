"""LightGCN pretraining in the port against the JAX package, on the CPU at
small sizes.

Tolerances:
  * ``bpr_loss``: rtol 1e-6 (the same float32 terms, summed in another
    order);
  * ``NativeCSR.sample_bpr``, ``generate_ml100k_csv``, ``load_ml100k``
    and the hits behind ``lightgcn_topn_metrics``: exact; its means rtol
    1e-6 (float32 sums over the users, in XLA's order and in PyTorch's);
  * gradients through the differentiable product: rtol / atol 2e-4 against
    ``jax.grad`` of the JAX propagations with Pallas in interpret mode, as
    the JAX package's own test holds its custom VJP to the dense one;
  * ``pretrain`` at equal initial tables: the same log lines, and the
    tables within rtol 5e-3 / atol 5e-4, the tolerance the JAX package
    holds its sparse and dense pretraining to.
"""

import filecmp

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch.data import loader as TL  # noqa: E402
from gdmcf_torch.data.native import NativeCSR  # noqa: E402
from gdmcf_torch.models import lightgcn as TG  # noqa: E402
from gdmcf_torch.ops import metrics as TM  # noqa: E402
from gdmcf_torch.ops import spmm as TS  # noqa: E402
from gdmcf_tpu.data import loader as JL  # noqa: E402
from gdmcf_tpu.data import native as JN  # noqa: E402
from gdmcf_tpu.models import lightgcn as JG  # noqa: E402
from gdmcf_tpu.models.layers import xavier_uniform  # noqa: E402
from gdmcf_tpu.ops import metrics as JM  # noqa: E402
from gdmcf_tpu.ops import spmm as JS  # noqa: E402

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
TABLE_TOL = dict(rtol=5e-3, atol=5e-4)


def random_csr(seed, n_user, n_item, p):
    rng = np.random.default_rng(seed)
    return sp.csr_matrix((rng.random((n_user, n_item)) < p).astype(
        np.float32))


def native_lib():
    lib = JN._ensure_lib()
    if lib is None:
        pytest.skip("the JAX package's C++ data engine did not build here "
                    "(no g++), so its BPR triples cannot be compared")
    return lib


# ---------------------------------------------------------------------------
# loss, sampler, ingest, metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bpr_loss_matches_jax(seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((37, 16)).astype(np.float32) * (1 + 4 * j)
            for j in range(6)]
    loss, reg = TG.bpr_loss(*[torch.from_numpy(a) for a in arrs], 37)
    jloss, jreg = JG.bpr_loss(*[jnp.asarray(a) for a in arrs], 37)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(reg.item(), float(jreg), rtol=1e-6)


def sampler_matrix(seed):
    """Users with no items, a user missing one item, and random rows."""
    m = random_csr(seed, 300, 50, 0.3).toarray()
    m[[3, 40, 41]] = 0
    m[7] = 1
    m[7, 13] = 0
    m[8, :25] = 1
    return sp.csr_matrix(m)


@pytest.mark.parametrize("seed", [0, 7, 2**62 - 1, 123456789012345678])
def test_sample_bpr_is_the_cpp_engine_bit_for_bit(seed):
    native_lib()
    csr = sampler_matrix(1)
    users = np.random.default_rng(2).integers(0, 300, 4096)
    users[:6] = [3, 40, 41, 7, 7, 8]
    pos, neg = NativeCSR.from_scipy(csr).sample_bpr(users, seed)
    jpos, jneg = JN.NativeCSR.from_scipy(csr).sample_bpr(users, seed)
    assert pos.dtype == jpos.dtype == np.int32
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(neg, jneg)
    dense = csr.toarray()
    has = dense[users].sum(axis=1) > 0
    assert (dense[users[has], pos[has]] == 1).all()
    assert (dense[users[has], neg[has]] == 0).all()
    assert neg[4] == 13 == neg[3]   # the one item user 7 lacks


def test_sample_bpr_refuses_a_user_holding_every_item():
    m = random_csr(3, 20, 12, 0.3).toarray()
    m[5] = 1
    ncsr = NativeCSR.from_scipy(sp.csr_matrix(m))
    with pytest.raises(ValueError, match="all 12 items"):
        ncsr.sample_bpr(np.arange(4), 0)


def test_sample_bpr_batch_validity():
    csr = random_csr(4, 30, 20, 0.3)
    users, pos, neg = TG.sample_bpr_batch(np.random.default_rng(0), csr, 16)
    dense = csr.toarray()
    assert np.array_equal(users, np.sort(users))
    for u, p, n in zip(users, pos, neg):
        if dense[u].sum() > 0:
            assert dense[u, p] == 1 and dense[u, n] == 0
    full = sp.csr_matrix(np.ones((3, 4), np.float32))
    with pytest.raises(ValueError, match="all 4 items"):
        TG.sample_bpr_batch(np.random.default_rng(0), full, 2)


@pytest.mark.parametrize("kw", [
    dict(n_user=60, n_item=90, avg_degree=12, seed=3),
    dict(n_user=400, n_item=600, avg_degree=40, seed=0),
])
def test_ml100k_csv_and_ingest_match_jax(tmp_path, kw):
    ours = TL.generate_ml100k_csv(str(tmp_path / "t" / "u.data"), **kw)
    theirs = JL.generate_ml100k_csv(str(tmp_path / "j" / "u.data"), **kw)
    assert filecmp.cmp(ours, theirs, shallow=False)
    got, want = TL.load_ml100k(ours), JL.load_ml100k(theirs)
    assert got[2:] == want[2:]
    if kw["seed"] == 0:   # the LightGCN gate's dataset
        assert got[2:] == (400, 584)
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape and a.dtype == b.dtype
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("k", [5, 10])
def test_lightgcn_topn_metrics_match_jax(k):
    rng = np.random.default_rng(k)
    gt = (rng.random((64, 40)) < 0.15).astype(np.float32)
    gt[[0, 9, 33]] = 0                        # users without ground truth
    gt[5] = 1
    pred = np.argsort(rng.random((64, 40)), axis=1)[:, :12]
    hits, count = TM._hits_and_counts(gt, pred, (k,))
    jhits, jcount = JM._hits_and_counts(gt, pred, (k,))
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    got = TM.lightgcn_topn_metrics(gt, pred, k)
    want = JM.lightgcn_topn_metrics(gt, pred, k)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert TM.lightgcn_topn_metrics(torch.from_numpy(gt),
                                    torch.from_numpy(pred), k) == got


# ---------------------------------------------------------------------------
# the differentiable product
# ---------------------------------------------------------------------------

def grad_inputs(seed, n_user, n_item, d):
    rng = np.random.default_rng(seed)
    csr = random_csr(seed, n_user, n_item, 0.25)
    w_u = rng.standard_normal((n_user, d)).astype(np.float32)
    w_i = rng.standard_normal((n_item, d)).astype(np.float32)
    e0 = rng.standard_normal((n_user + n_item, d)).astype(np.float32)
    return csr, w_u, w_i, e0


def torch_grad(prop, e0, w_u, w_i):
    e = torch.from_numpy(e0).requires_grad_(True)
    fu, fi = prop(e)
    loss = (fu * torch.from_numpy(w_u)).sum() + (fi * torch.from_numpy(
        w_i)).sum()
    (g,) = torch.autograd.grad(loss, e)
    return g.numpy()


@pytest.mark.parametrize("fmt", ["sparse", "hybrid"])
@pytest.mark.parametrize("d", [6, 64])
def test_product_gradients_match_jax_grad(fmt, d):
    n_user, n_item, layers = 24, 20, 2
    csr, w_u, w_i, e0 = grad_inputs(d, n_user, n_item, d)
    if fmt == "sparse":
        jn = JG.normalized_bipartite_sparse(csr, br=16, bc=16)
        meta, arrs = JS.block_sparse_meta(jn), JS.block_sparse_arrays(jn)
        jprop, tn = JG.propagate_sparse, TG.normalized_bipartite_sparse(
            csr, br=16, bc=16)
    else:
        jn = JG.normalized_bipartite_hybrid(csr, br=8, bc=16)
        meta, arrs = JS.hybrid_meta(jn), JS.hybrid_arrays(jn)
        jprop, tn = JG.propagate_hybrid, TG.normalized_bipartite_hybrid(
            csr, br=8, bc=16)

    def jloss(e):
        fu, fi = jprop(e[:n_user], e[n_user:], meta, arrs, layers,
                       interpret=True)
        return (fu * w_u).sum() + (fi * w_i).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(e0)))
    TS.reset_launch_counts()
    got = torch_grad(lambda e: TG.propagate_rows(
        e[:n_user], e[n_user:], tn.fwd_rows, tn.t_rows, layers), e0, w_u,
        w_i)
    assert TS.LAUNCHES == {"spmm_rows_fwd": 0, "spmm_rows_t": 0}
    np.testing.assert_allclose(got, want, **GRAD_TOL)
    n_mat = torch.from_numpy(TG.normalized_bipartite_blocks(csr))
    dense = torch_grad(lambda e: TG.propagate(e[:n_user], e[n_user:], n_mat,
                                              layers), e0, w_u, w_i)
    np.testing.assert_allclose(got, dense, **GRAD_TOL)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n_x", [17, 40, 64])
def test_spmm_op_backward_is_the_other_direction(transpose, n_x):
    """The gradient of x is A^T g (or A g), cut or padded to x's rows: x
    may be shorter than the operand's columns (40 and 48 before padding to
    the tiles) or longer (the extra rows get zero gradient)."""
    rng = np.random.default_rng(n_x)
    m = sp.random(40, 48, density=0.2, random_state=np.random.RandomState(
        n_x), format="csr", dtype=np.float32)
    h = TS.to_hybrid(m, br=8, bc=16, min_fill=3)
    a = m.toarray().T if transpose else m.toarray()
    x = torch.from_numpy(rng.standard_normal((n_x, 5)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((64, 5)).astype(np.float32))
    y = TS.hybrid_spmm(h, x, transpose)
    (y[:a.shape[0]] * w[:a.shape[0]]).sum().backward()
    want = np.zeros((n_x, 5), np.float32)
    k = min(n_x, a.shape[1])
    want[:k] = (a.T @ w[:a.shape[0]].numpy())[:k]
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    assert x.grad.shape == x.shape and not x.grad[a.shape[1]:].any()


def test_spmm_rows_refuses_a_gradient_it_cannot_carry():
    h = TS.to_hybrid(sp.random(16, 16, density=0.3, format="csr",
                               random_state=np.random.RandomState(0),
                               dtype=np.float32), br=8, bc=16)
    x = torch.ones(16, 3, requires_grad=True)
    with pytest.raises(ValueError, match="spmm_op"):
        TS.spmm_rows(h.fwd_rows, x)
    with torch.no_grad():
        TS.spmm_rows(h.fwd_rows, x)
    with pytest.raises(ValueError, match="other direction"):
        TS.spmm_op(h.fwd_rows, h.fwd_rows, x)


# ---------------------------------------------------------------------------
# pretrain
# ---------------------------------------------------------------------------

PRETRAIN_KW = dict(n_layers=2, latent_dim=8, epochs=2, batch_size=16, seed=0)


@pytest.mark.parametrize("sparse,extra", [
    (False, {}), (True, dict(block_size=16)),
    ("hybrid", dict(block_size=16, block_rows=8))])
def test_pretrain_matches_jax_at_equal_initial_tables(sparse, extra):
    native_lib()   # the JAX pretrain samples with the C++ engine
    train = random_csr(10, 30, 24, 0.25)
    test = random_csr(11, 30, 24, 0.1)
    init = np.asarray(xavier_uniform(jax.random.PRNGKey(0), (54, 8)))
    jlog, tlog = [], []
    want = JG.pretrain(train, test, sparse=sparse, log=jlog.append,
                       spmm_interpret=True, **extra, **PRETRAIN_KW)
    got = TG.pretrain(train, test, sparse=sparse, log=tlog.append,
                      device="cpu", init_table=init, **extra, **PRETRAIN_KW)
    assert tlog == jlog and len(tlog) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **TABLE_TOL)
    assert not np.allclose(got.initial_user, init[:30])


def test_pretrain_draws_its_own_table_and_refuses_bad_arguments(tmp_path):
    train = random_csr(12, 20, 16, 0.3)
    logs = []
    res = TG.pretrain(train, train, log=logs.append, device="cpu",
                      evaluate=False, steps_per_epoch=3, **PRETRAIN_KW)
    assert [ln.split(":")[0] for ln in logs] == ["epoch 0", "epoch 1"]
    assert "recall" not in logs[0]
    again = TG.pretrain(train, train, log=lambda *a: None, device="cpu",
                        evaluate=False, steps_per_epoch=3, **PRETRAIN_KW)
    for a, b in zip(res, again):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="sparse='blocks'"):
        TG.pretrain(train, train, sparse="blocks", device="cpu")
    with pytest.raises(ValueError, match="init_table shape"):
        TG.pretrain(train, train, device="cpu", init_table=np.zeros((3, 8)),
                    **PRETRAIN_KW)
    TG.save_embeddings(res, str(tmp_path / "emb"))
    with np.load(tmp_path / "emb" / "lightgcn_embeddings.npz") as z:
        assert sorted(z.files) == ["final_item_Embed", "final_user_Embed",
                                   "initial_item_Embed",
                                   "initial_user_Embed"]
        assert z["final_user_Embed"].shape == (20, 8)
        assert z["initial_item_Embed"].shape == (16, 8)
        np.testing.assert_array_equal(z["final_item_Embed"], res.final_item)


def test_pretrain_starts_from_initial_table():
    """With no init_table, pretrain starts from initial_table(seed): zero
    epochs return it as the initial tables, and a seed draws the same
    table each time (on the CPU generator, whatever the device)."""
    train = random_csr(16, 20, 16, 0.3)
    table = TG.initial_table(36, 8, 3, "cpu")
    limit = np.sqrt(6.0 / (36 + 8))
    assert table.shape == (36, 8) and float(table.abs().max()) <= limit
    assert torch.equal(table, TG.initial_table(36, 8, 3, "cpu"))
    assert not torch.equal(table, TG.initial_table(36, 8, 4, "cpu"))
    res = TG.pretrain(train, train, n_layers=2, latent_dim=8, epochs=0,
                      seed=3, evaluate=False, device="cpu")
    np.testing.assert_array_equal(res.initial_user, table[:20].numpy())
    np.testing.assert_array_equal(res.initial_item, table[20:].numpy())


def test_pretrain_final_tables_are_the_propagated_initial_ones():
    train = random_csr(13, 26, 30, 0.2)
    res = TG.pretrain(train, train, sparse="hybrid", block_size=16,
                      device="cpu", evaluate=False, log=lambda *a: None,
                      **PRETRAIN_KW)
    h = TG.normalized_bipartite_hybrid(train, br=8, bc=16)
    fu, fi = TG._layers(
        torch.from_numpy(res.initial_user), torch.from_numpy(res.initial_item),
        2, lambda x: TS.hybrid_spmm_reference(h, x, False),
        lambda x: TS.hybrid_spmm_reference(h, x, True))
    np.testing.assert_allclose(res.final_user, fu.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(res.final_item, fi.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_dense_limit_crossover_pretrain(monkeypatch):
    """sparse=None honours _DENSE_LIMIT_BYTES on both sides of the
    boundary, and the two sides agree: the choice changes the schedule,
    not the result."""
    n_user, n_item = 30, 24
    csr = random_csr(14, n_user, n_item, 0.25)
    test = random_csr(15, n_user, n_item, 0.1)
    dense_bytes = n_user * n_item * 4
    kw = dict(PRETRAIN_KW, evaluate=False, block_size=16, device="cpu",
              log=lambda *a: None)
    calls = {"dense": 0, "sparse": 0}
    orig_prop, orig_rows = TG.propagate, TG.propagate_rows

    def spy_dense(*a, **k):
        calls["dense"] += 1
        return orig_prop(*a, **k)

    def spy_rows(*a, **k):
        calls["sparse"] += 1
        return orig_rows(*a, **k)

    monkeypatch.setattr(TG, "propagate", spy_dense)
    monkeypatch.setattr(TG, "propagate_rows", spy_rows)
    monkeypatch.setattr(TG, "_DENSE_LIMIT_BYTES", dense_bytes)
    below = TG.pretrain(csr, test, sparse=None, **kw)
    assert calls["dense"] > 0 and calls["sparse"] == 0

    calls.update(dense=0, sparse=0)
    monkeypatch.setattr(TG, "_DENSE_LIMIT_BYTES", dense_bytes - 1)
    above = TG.pretrain(csr, test, sparse=None, **kw)
    assert calls["sparse"] > 0 and calls["dense"] == 0
    for a, b in zip(above, below):
        np.testing.assert_allclose(a, b, **TABLE_TOL)

    # above the limit the evaluation turns itself off, with a warning
    with pytest.warns(UserWarning, match="disabling the dense ranking"):
        TG.pretrain(csr, test, sparse=None, **dict(kw, evaluate=True))
