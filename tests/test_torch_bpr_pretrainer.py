"""``models.lightgcn.BPRPretrainer``, the stepping pretrainer that
``pretrain`` runs, on the CPU at a tiny size: its steps are ``pretrain``'s
bit for bit, a saved start put back repeats the same steps bit for bit,
the triples it reports are those it trained on, a step's gradient (the
propagation of the batch's row gradients) is autograd's through the whole
propagation, and its ``gdmcf.bpr.*`` spans are silent without a profiler
and counted with one.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import profile  # noqa: E402

from gdmcf_torch.models import lightgcn as TG  # noqa: E402
from gdmcf_torch.utils import profiling as P  # noqa: E402

N_USER, N_ITEM = 40, 30
KW = dict(n_layers=3, latent_dim=8, batch_size=16, lr=1e-3, decay=1e-4,
          seed=5, block_size=16, device="cpu")
FORMATS = [False, True, "hybrid"]
SPANS = ("gdmcf.bpr.sample", "gdmcf.bpr.feed", "gdmcf.bpr.step",
         "gdmcf.bpr.grad", "gdmcf.bpr.loss_fetch")


def graph(seed=3):
    rng = np.random.default_rng(seed)
    return sp.csr_matrix((rng.random((N_USER, N_ITEM)) < 0.2).astype(
        np.float32))


@pytest.mark.parametrize("sparse", FORMATS)
def test_steps_over_two_epochs_are_pretrains_tables_bit_for_bit(sparse):
    train = graph()
    steps = train.nnz // KW["batch_size"]
    logs = []
    want = TG.pretrain(train, train, epochs=2, sparse=sparse,
                       evaluate=False, log=logs.append, **KW)
    pt = TG.BPRPretrainer(train, sparse=sparse, **KW)
    totals = [pt.loss_total(pt.steps(steps)) for _ in range(2)]
    got = pt.tables()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert logs == [f"epoch {e}: loss {t / steps:.4f}"
                    for e, t in enumerate(totals)]
    assert pt.n_steps == 2 * steps


@pytest.mark.parametrize("sparse", FORMATS)
def test_a_restored_start_repeats_the_losses_and_the_table(sparse):
    pt = TG.BPRPretrainer(graph(), sparse=sparse, **KW)
    pt.steps(2)
    start = pt.state()
    first = pt.steps(5)
    table, mu = pt.e0.detach().clone(), pt.opt_state.mu["e0"].clone()
    triples = pt.recent(5)
    pt.restore(start)
    assert pt.n_steps == 2 and pt.recent(0).shape == (0, 3, 16)
    assert torch.equal(pt.e0.detach(), torch.from_numpy(start.e0))
    again = pt.steps(5)
    assert torch.equal(first, again)
    assert torch.equal(pt.e0.detach(), table)
    assert torch.equal(pt.opt_state.mu["e0"], mu)
    assert int(pt.opt_state.count) == 7
    np.testing.assert_array_equal(pt.recent(5), triples)
    # the start is a copy: stepping did not move it
    pt.restore(start)
    assert torch.equal(pt.steps(5), first)


def test_the_triples_it_reports_are_the_ones_it_trained_on(monkeypatch):
    train = graph(4)
    pt = TG.BPRPretrainer(train, sparse="hybrid", keep_batches=4, **KW)
    seen, inner = [], TG.bpr_step

    def spy(e0, opt_state, prop, batch, *a):
        seen.append(batch.numpy().copy())
        return inner(e0, opt_state, prop, batch, *a)

    monkeypatch.setattr(TG, "bpr_step", spy)
    pt.steps(6)
    got = pt.recent(4)
    assert got.shape == (4, 3, 16) and got.dtype == np.int64
    np.testing.assert_array_equal(got, np.stack(seen[2:]))
    with pytest.raises(ValueError, match="5 steps asked for"):
        pt.recent(5)
    dense = train.toarray()
    for users, pos, neg in got:
        assert len(set(users.tolist())) == 16
        assert (dense[users, pos] == 1).all()
        assert (dense[users, neg] == 0).all()


def test_the_spans_are_silent_without_a_profiler_and_counted_with_one():
    pt = TG.BPRPretrainer(graph(), sparse="hybrid", **KW)
    P.clear_span_totals()
    pt.loss_total(pt.steps(3))
    assert P.span_totals() == {}
    start = pt.state()
    off = pt.steps(3)
    pt.restore(start)
    with profile() as prof:
        on = pt.steps(3)
        pt.loss_total(on)
    totals = P.span_totals()
    assert {k: v[0] for k, v in totals.items()} == {
        "gdmcf.bpr.sample": 3, "gdmcf.bpr.feed": 3, "gdmcf.bpr.step": 3,
        "gdmcf.bpr.grad": 3, "gdmcf.bpr.loss_fetch": 1}
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("gdmcf.bpr.")]
    assert sorted(set(names)) == sorted(SPANS)
    # the spans change nothing the steps compute
    assert torch.equal(on, off)
    P.clear_span_totals()


def _autograd_step(e0, prop, batch, decay):
    """The step's loss and gradient by autograd through the whole
    propagation, as the step took them before it propagated the rows'
    gradients."""
    users, pos, neg = batch
    e = e0.detach().clone().requires_grad_(True)
    fu, fi = prop(e)
    loss, reg = TG.bpr_loss(fu[users], fi[pos], fi[neg], e[users],
                            e[N_USER + pos], e[N_USER + neg], users.shape[0])
    total = loss + decay * reg
    (grad,) = torch.autograd.grad(total, e)
    return total.detach(), grad


@pytest.mark.parametrize("sparse", FORMATS)
def test_the_steps_gradient_is_autograds_through_the_propagation(
        sparse, monkeypatch):
    train = graph().tolil()
    train[0, :] = 0        # user 0 has an empty row
    train = train.tocsr()
    train.eliminate_zeros()
    prop = TG.propagator(train, 3, sparse, block_size=16, device="cpu")
    # user 0 twice; item 2 a positive three times and a negative once,
    # item 1 a negative twice, item 4 a positive and a negative
    batch = torch.tensor([
        [0, 0, 3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27, 39],
        [1, 2, 2, 4, 6, 2, 8, 10, 12, 14, 16, 18, 20, 22, 24, 29],
        [2, 3, 5, 1, 1, 6, 9, 11, 13, 15, 17, 19, 21, 23, 25, 4]])
    lr, decay = 1e-3, 1e-2
    e0 = TG.initial_table(N_USER + N_ITEM, 8, 5, "cpu")
    want_loss, want_grad = _autograd_step(e0, prop, batch, decay)
    want = e0.clone()
    TG.fused_adamw_apply({"e0": want}, {"e0": want_grad},
                         TG.fused_adamw_init({"e0": want}, torch.float32),
                         lr=lr)

    seen, inner = {}, TG.fused_adamw_apply

    def spy(params, grads, state, **kw):
        seen.update(grads)
        return inner(params, grads, state, **kw)

    monkeypatch.setattr(TG, "fused_adamw_apply", spy)
    e0.requires_grad_(True)
    state = TG.fused_adamw_init({"e0": e0}, torch.float32)
    state, loss = TG.bpr_step(e0, state, prop, batch, N_USER, lr, decay)
    assert torch.equal(loss, want_loss)
    assert seen["e0"].is_contiguous()
    torch.testing.assert_close(seen["e0"], want_grad, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(e0.detach(), want, rtol=1e-5, atol=1e-7)
    assert int(state.count) == 1


@pytest.mark.parametrize("sparse", FORMATS)
def test_the_propagator_is_self_adjoint(sparse):
    """<P a, b> = <a, P b>: what lets the step take the table's gradient
    as the propagation of the rows' gradients."""
    prop = TG.propagator(graph(), 3, sparse, block_size=16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randn(N_USER + N_ITEM, 8, generator=gen)
            for _ in range(2))
    pa, pb = torch.cat(prop(a)).double(), torch.cat(prop(b)).double()
    lhs, rhs = float((pa * b.double()).sum()), float((a.double() * pb).sum())
    assert lhs == pytest.approx(rhs, rel=1e-5)


def test_a_misspelt_operand_format_is_refused():
    with pytest.raises(ValueError, match="sparse='tiles'"):
        TG.BPRPretrainer(graph(), sparse="tiles", **KW)


def test_the_operands_are_the_propagators_row_operands():
    train = graph()
    fwd, t = TG.BPRPretrainer(train, sparse="hybrid", **KW).operands()
    assert not fwd.transpose and t.transpose
    assert fwd.nnz == t.nnz == train.nnz
    assert TG.BPRPretrainer(train, sparse=False, **KW).operands() is None
