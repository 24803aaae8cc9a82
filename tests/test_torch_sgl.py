"""SGL-ED pretraining (``models.sgl`` through ``models.lightgcn.
BPRPretrainer``) on the CPU at a small size: the steps against the plain
reference (``h100bench/reference/sgl.py``: its own N and views, autograd
over the whole table, textbook Adam), the chunked InfoNCE against one
block under autograd, each view's propagated gradient against autograd
through its propagation, the view draw, the views' save and restore,
``ssl_reg=0`` bit for bit the BPR step, ``pretrain``'s per-epoch redraw
and ``pretrain_cli``'s flags.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import profile  # noqa: E402

from gdmcf_torch.models import lightgcn as TG  # noqa: E402
from gdmcf_torch.models import sgl as S  # noqa: E402
from gdmcf_torch.utils import profiling as P  # noqa: E402
from h100bench.reference import sgl as RS  # noqa: E402

N_USER, N_ITEM = 60, 40
KW = dict(n_layers=3, latent_dim=16, batch_size=16, lr=1e-3, decay=1e-4,
          seed=5, block_size=16, device="cpu")
SSL = dict(ssl_reg=0.5, ssl_ratio=0.1, ssl_temp=0.2)
FORMATS = [False, "hybrid"]


def graph(seed=3):
    rng = np.random.default_rng(seed)
    return sp.csr_matrix((rng.random((N_USER, N_ITEM)) < 0.2).astype(
        np.float32))


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("sparse", FORMATS)
def test_sgl_steps_follow_the_plain_reference(sparse, monkeypatch):
    """Loss, the whole table's gradient and the table after 3 steps, the
    program against the reference on the program's triples and views."""
    grads, inner = [], TG.fused_adamw_apply

    def spy(params, g, state, **kw):
        grads.append(g["e0"].clone())
        return inner(params, g, state, **kw)

    monkeypatch.setattr(TG, "fused_adamw_apply", spy)
    train = graph()
    pt = TG.BPRPretrainer(train, sparse=sparse, **KW, **SSL)
    start = pt.e0.detach().clone()
    losses = pt.steps(3).tolist()
    ref = RS.Pretrainer(train, pt.views(), start.numpy(), 3, KW["lr"],
                        KW["decay"], 0.5, 0.2, "cpu")
    ref.step(pt.recent(3)[0])
    assert rel(grads[0], ref.first_grad) < 1e-5
    for b in pt.recent(3)[1:]:
        ref.step(b)
    np.testing.assert_allclose(losses, ref.losses, rtol=1e-6)
    assert rel(pt.e0.detach() - start, ref.e0 - start) < 1e-4
    # the InfoNCE moves the loss: BPR alone starts near log 2
    assert losses[0] > np.log(2) + 0.2


def _one_block(q, keys, pos, temp):
    qn = torch.nn.functional.normalize(q, dim=1)
    kn = torch.nn.functional.normalize(keys, dim=1)
    logits = qn @ kn.T / temp
    return (torch.logsumexp(logits, 1)
            - logits.gather(1, pos[:, None])[:, 0]).mean()


@pytest.mark.parametrize("chunk", [7, 33, 100, 1000])
def test_the_chunked_info_nce_is_one_block_under_autograd(chunk):
    # in float64, so that the chunks' other order of sums shows only at
    # its rounding
    gen = torch.Generator().manual_seed(chunk)
    q = torch.randn(12, 8, generator=gen, dtype=torch.float64) * 0.01
    keys = torch.randn(100, 8, generator=gen, dtype=torch.float64) * 0.01
    # key 3 is the positive of three rows
    pos = torch.tensor([3, 3, 3, 0, 99, 50, 7, 8, 9, 10, 11, 12])
    loss, dq, dk, chunks = S.info_nce(q, keys, pos, 0.2, chunk)
    assert chunks == -(-100 // chunk)
    qa, ka = q.clone().requires_grad_(), keys.clone().requires_grad_()
    want = _one_block(qa, ka, pos, 0.2)
    want_dq, want_dk = torch.autograd.grad(want, (qa, ka))
    torch.testing.assert_close(loss, want, rtol=1e-12, atol=0)
    torch.testing.assert_close(dq, want_dq, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(dk, want_dk, rtol=1e-10, atol=1e-12)
    # every key's row has a gradient, not only the positives'
    assert bool((dk.abs().sum(1) > 0).all())


@pytest.mark.parametrize("sparse", FORMATS)
def test_a_views_propagated_gradient_is_autograds_through_it(sparse):
    """P_v s against autograd of <P_v a, s> at a: each P_v is symmetric,
    so the step propagates the rows' gradients of view 1 and view 2."""
    pt = TG.BPRPretrainer(graph(), sparse=sparse, **KW, **SSL)
    gen = torch.Generator().manual_seed(1)
    s = torch.randn(N_USER + N_ITEM, 16, generator=gen)
    a = torch.randn(N_USER + N_ITEM, 16, generator=gen).requires_grad_()
    for prop in pt.sgl.props:
        (want,) = torch.autograd.grad((torch.cat(prop(a)) * s).sum(), a)
        with torch.no_grad():
            got = torch.cat(prop(s))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _dense(op, shape):
    rows = np.repeat(np.arange(op.n_out), np.diff(op.row_ptr.numpy()))
    m = np.zeros((op.n_out, int(op.cols.max()) + 1), np.float32)
    np.add.at(m, (rows, op.cols.numpy()), op.vals.numpy())
    return m[:shape[0], :shape[1]]


def test_the_views_are_drawn_as_sgl_ed_draws_them():
    train = graph()
    nnz = train.nnz
    pt = TG.BPRPretrainer(train, sparse="hybrid", **KW, **SSL)
    views = pt.views()
    want = int(np.floor(0.9 * nnz))
    assert len(views) == 2 and not np.array_equal(*views)
    for kept in views:
        assert kept.dtype == np.int64 and len(kept) == want
        assert np.array_equal(kept, np.unique(kept))
        assert kept.min() >= 0 and kept.max() < nnz
    assert RS.invalid_views(train, views, 0.1) == 0
    coo = train.tocoo()
    for kept, (fwd, t) in zip(views, pt.sgl.operands()):
        # both directions hold the same kept cells, normalized on the
        # view's own degrees
        r = np.zeros(train.shape, np.float32)
        r[coo.row[kept], coo.col[kept]] = 1
        du, di = r.sum(1), r.sum(0)
        with np.errstate(divide="ignore"):
            n_v = r / np.sqrt(np.where(du > 0, du, np.inf))[:, None] \
                / np.sqrt(np.where(di > 0, di, np.inf))[None, :]
        np.testing.assert_allclose(_dense(fwd, train.shape), n_v,
                                   rtol=1e-6)
        np.testing.assert_allclose(_dense(t, train.shape[::-1]), n_v.T,
                                   rtol=1e-6)
        assert fwd.nnz == t.nnz == want
    # the same seed draws the same views; a redraw draws other ones
    again = TG.BPRPretrainer(train, sparse="hybrid", **KW, **SSL)
    for a, b in zip(views, again.views()):
        np.testing.assert_array_equal(a, b)
    again.redraw_views()
    assert pt.sgl.counts["views_drawn"] == 2
    assert again.sgl.counts["views_drawn"] == 4
    assert not any(np.array_equal(a, b) for a in views
                   for b in again.views())
    assert S.kept_count(nnz, 0.0) == nnz
    with pytest.raises(ValueError, match="ssl_ratio=1"):
        TG.BPRPretrainer(train, **KW, ssl_reg=0.5, ssl_ratio=1)


@pytest.mark.parametrize("sparse", FORMATS)
def test_a_restored_start_puts_the_views_back(sparse):
    pt = TG.BPRPretrainer(graph(), sparse=sparse, **KW, **SSL)
    pt.steps(2)
    start = pt.state()
    first = pt.steps(3)
    table = pt.e0.detach().clone()
    saved = pt.views()
    pt.redraw_views()
    assert not np.array_equal(pt.views()[0], saved[0])
    seconds = len(pt.sgl.seconds)
    pt.restore(start)
    # the views were rebuilt from the start's kept edges
    assert len(pt.sgl.seconds) == seconds + 2
    for a, b in zip(pt.views(), saved):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(pt.steps(3), first)
    assert torch.equal(pt.e0.detach(), table)
    # unchanged views are not rebuilt
    pt.restore(start)
    assert len(pt.sgl.seconds) == seconds + 2
    assert torch.equal(pt.steps(3), first)
    with pytest.raises(ValueError, match="SGL views"):
        TG.BPRPretrainer(graph(), sparse=sparse, **KW).restore(start)


def _steps_before_sgl(e0, opt_state, prop, batch, n_user, lr, decay):
    """``bpr_step`` as it stood before the SGL objective."""
    users, pos, neg = batch
    rows = (users, n_user + pos, n_user + neg)
    with torch.no_grad():
        fu, fi = prop(e0)
        leaves = [t.requires_grad_() for t in (
            fu[users], fi[pos], fi[neg], *(e0[r] for r in rows))]
    loss, reg = TG.bpr_loss(*leaves, users.shape[0])
    total = loss + decay * reg
    grads = torch.autograd.grad(total, leaves)
    seed = torch.zeros_like(e0)
    for r, g in zip(rows, grads[:3]):
        seed.index_put_((r,), g, accumulate=True)
    with torch.no_grad():
        grad = torch.cat(prop(seed))
        for r, g in zip(rows, grads[3:]):
            grad.index_put_((r,), g, accumulate=True)
    opt_state = TG.fused_adamw_apply({"e0": e0}, {"e0": grad}, opt_state,
                                     lr=lr)
    return opt_state, total.detach()


@pytest.mark.parametrize("sparse", FORMATS)
def test_ssl_reg_zero_is_the_bpr_pretrainer_bit_for_bit(sparse,
                                                        monkeypatch):
    train = graph()
    pt = TG.BPRPretrainer(train, sparse=sparse, **KW, ssl_reg=0.0)
    assert pt.views() is None and pt.sgl is None
    assert pt.state().views is None
    with pytest.raises(ValueError, match="no SGL views"):
        pt.redraw_views()
    # nothing drawn for a view: the generator is where the seed put it
    assert pt.rng.bit_generator.state == np.random.default_rng(
        KW["seed"]).bit_generator.state
    got = pt.steps(6)
    monkeypatch.setattr(TG, "bpr_step", _steps_before_sgl)
    old = TG.BPRPretrainer(train, sparse=sparse, **KW)
    assert torch.equal(old.steps(6), got)
    assert torch.equal(old.e0.detach(), pt.e0.detach())
    assert torch.equal(old.opt_state.mu["e0"], pt.opt_state.mu["e0"])


def test_the_sgl_spans_are_counted_under_a_profiler():
    P.clear_span_totals()
    pt = TG.BPRPretrainer(graph(), sparse="hybrid", **KW, **SSL)
    pt.steps(2)
    assert not any(k.startswith("gdmcf.sgl.") for k in P.span_totals())
    with profile():
        pt.redraw_views()
        pt.loss_total(pt.steps(3))
    counts = {k: v[0] for k, v in P.span_totals().items()}
    assert {k: counts[k] for k in counts if k.startswith("gdmcf.sgl.")} \
        == {"gdmcf.sgl.views": 2, "gdmcf.sgl.infonce": 3,
            "gdmcf.sgl.grad": 3}
    assert counts["gdmcf.bpr.step"] == counts["gdmcf.bpr.grad"] == 3
    # one key chunk a side a step at this size
    assert pt.sgl.counts["infonce_chunks"] == 2 * 5
    P.clear_span_totals()


def test_the_infonce_chunks_follow_the_chunk_bytes(monkeypatch):
    monkeypatch.setattr(S, "INFONCE_CHUNK_BYTES", 4 * 16 * 7)
    assert S.chunk_rows(16) == 7
    pt = TG.BPRPretrainer(graph(), sparse="hybrid", **KW, **SSL)
    pt.steps(1)
    assert pt.sgl.counts["infonce_chunks"] == -(-N_USER // 7) - (-N_ITEM // 7)


def test_pretrain_redraws_the_views_each_later_epoch(monkeypatch):
    drawn, inner = [], TG.BPRPretrainer.redraw_views

    def spy(self):
        drawn.append(self.n_steps)
        return inner(self)

    monkeypatch.setattr(TG.BPRPretrainer, "redraw_views", spy)
    train = graph()
    steps = train.nnz // KW["batch_size"]
    logs = []
    res = TG.pretrain(train, train, epochs=3, sparse="hybrid",
                      evaluate=False, log=logs.append, **KW, **SSL)
    # construction's draw, then epochs 1 and 2 start with a redraw
    assert drawn == [0, steps, 2 * steps]
    assert len(logs) == 3 and res.final_user.shape == (N_USER, 16)
    assert all(np.isfinite(t).all() for t in res)


def test_pretrain_cli_runs_an_sgl_epoch_and_writes_lightgcns_tables(
        tmp_path, capsys):
    from gdmcf_torch import pretrain_cli
    from gdmcf_torch.data.loader import (data_load_dir,
                                         generate_synthetic_dataset)

    data = str(tmp_path / "data")
    generate_synthetic_dataset(data, n_user=80, n_item=60, avg_degree=8,
                               seed=1)
    _, _, _, n_user, n_item = data_load_dir(data)
    flags = ["--device", "cpu", "--data_path", data, "--epochs", "1",
             "--batch_size", "32", "--latent_dim", "8", "--n_layers", "2"]
    tables = {}
    for name, extra in (("lightgcn", []),
                        ("sgl", ["--ssl_reg", "0.5", "--ssl_ratio", "0.1",
                                 "--ssl_temp", "0.2"])):
        out = tmp_path / name
        pretrain_cli.main(flags + extra + ["--out_dir", str(out)])
        with np.load(out / "lightgcn_embeddings.npz") as z:
            tables[name] = {k: z[k] for k in z.files}
    text = capsys.readouterr().out
    assert "SGL-ED (ssl_reg 0.5, ssl_ratio 0.1, ssl_temp 0.2)" in text
    lgn, sgl = tables["lightgcn"], tables["sgl"]
    assert {k: (v.shape, v.dtype) for k, v in sgl.items()} \
        == {k: (v.shape, v.dtype) for k, v in lgn.items()}
    assert sgl["final_user_Embed"].shape == (n_user, 8)
    assert sgl["final_item_Embed"].shape == (n_item, 8)
    assert all(np.isfinite(v).all() for v in sgl.values())
    # the contrastive term trained other tables from the same start
    np.testing.assert_array_equal(sgl["initial_user_Embed"].shape,
                                  lgn["initial_user_Embed"].shape)
    assert not np.array_equal(sgl["final_user_Embed"],
                              lgn["final_user_Embed"])


@pytest.mark.gpu
def test_an_sgl_step_launches_six_products_on_each_operand(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gdmcf_torch.train.trainer import matmul_precision

    pt = TG.BPRPretrainer(graph(), sparse="hybrid", **dict(
        KW, device="cuda"), **SSL)
    ops = [*pt.operands(), *(o for pair in pt.sgl.operands()
                             for o in pair)]
    with matmul_precision(tf32=False):
        start = pt.e0.detach().cpu().numpy()
        pt.steps(1)
    # 3 layers forward and 3 in the propagation of the gradient
    assert [op.launches for op in ops] == [6] * 6
    ref = RS.Pretrainer(graph(), pt.views(), start, 3, KW["lr"],
                        KW["decay"], 0.5, 0.2, "cuda")
    ref.step(pt.recent(1)[0])
    assert rel(pt.e0.detach() - torch.from_numpy(start).cuda(),
               ref.e0 - torch.from_numpy(start).cuda()) < 1e-4
