"""The port's spans (``gdmcf_torch.utils.profiling.span``) on the CPU: off
(the shared no-op, no profiler range opened) unless a ``torch.profiler``
records; host ranges in the profiler's trace and in ``span_totals`` while
one does; the spans ``train_epoch`` and ``evaluate_streaming`` emit, one
per batch, group, step or pass; and results bitwise equal with the
profiler on and off.
"""

import contextlib

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.autograd.profiler as autograd_profiler  # noqa: E402
from torch.profiler import profile  # noqa: E402

from gdmcf_torch.config import Config  # noqa: E402
from gdmcf_torch.data.loader import DiffusionDataset  # noqa: E402
from gdmcf_torch.data.native import NativeCSR  # noqa: E402
from gdmcf_torch.train.trainer import Trainer  # noqa: E402
from gdmcf_torch.utils import profiling as P  # noqa: E402

N_ITEM = 20


def cfg(**kw):
    base = dict(device="cpu", backbone="DNNOneHotEmbeddingGCN", dims=[12],
                emb_size=10, steps=5, noise_scale=0.01, sampling_steps=0,
                lr=1e-3, batch_size=8, topN=[5, 10], drop_last=False)
    base.update(kw)
    return Config(**base)


def binary(seed, n_user, p):
    rng = np.random.default_rng(seed)
    return (rng.random((n_user, N_ITEM)) < p).astype(np.float32)


def span_counts(prof):
    """{name: count} of the ``gdmcf.`` ranges in a finished profile."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("gdmcf."):
            assert str(e.device_type()).endswith("CPU"), e.name()
            out[e.name()] = out.get(e.name(), 0) + 1
    return out


@contextlib.contextmanager
def profiled():
    """The block under ``torch.profiler.profile`` with fresh span totals."""
    P.clear_span_totals()
    with profile() as prof:
        yield prof


def test_a_span_with_no_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened")

    monkeypatch.setattr(P, "_host_range", refuse)
    monkeypatch.setattr(P, "_Span", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    P.clear_span_totals()
    assert not autograd_profiler._is_profiler_enabled
    s = P.span("gdmcf.eval.group")
    assert s is P.NO_SPAN and P.span("gdmcf.train.group") is s
    with s:
        with P.span("gdmcf.eval.metrics"):
            pass
    assert P.span_totals() == {}


def test_the_flag_is_on_only_while_a_profiler_records(tmp_path):
    # the flag and the range that span reads and opens
    assert hasattr(torch._C._profiler, "_RecordFunctionFast")
    assert not autograd_profiler._is_profiler_enabled
    with profile():
        assert autograd_profiler._is_profiler_enabled
        assert P.span("gdmcf.x") is not P.NO_SPAN
    assert not autograd_profiler._is_profiler_enabled
    assert P.span("gdmcf.x") is P.NO_SPAN
    with P.trace(str(tmp_path / "t")):
        assert autograd_profiler._is_profiler_enabled
    assert not autograd_profiler._is_profiler_enabled


def test_spans_are_host_ranges_with_their_self_time():
    with profiled() as prof:
        with P.span("gdmcf.outer"):
            for _ in range(2):
                with P.span("gdmcf.inner"):
                    torch.ones(64, 64).sum()
        with P.span("gdmcf.alone"):
            pass
    assert span_counts(prof) == {"gdmcf.outer": 1, "gdmcf.inner": 2,
                                 "gdmcf.alone": 1}
    # the ranges lie in the trace beside the operators they ran
    assert any("sum" in e.name()
               for e in prof.profiler.kineto_results.events())
    tot = P.span_totals()
    assert [tot[n][0] for n in ("gdmcf.outer", "gdmcf.inner",
                                "gdmcf.alone")] == [1, 2, 1]
    _, total, self_s = tot["gdmcf.outer"]
    # self time: the span's time less its child spans'
    assert 0 < self_s < total
    assert self_s == pytest.approx(total - tot["gdmcf.inner"][1], abs=1e-12)
    for n in ("gdmcf.inner", "gdmcf.alone"):
        assert tot[n][2] == tot[n][1]
    P.clear_span_totals()
    assert P.span_totals() == {}


def streaming_case(k):
    """A Trainer at ``eval_batches_per_call`` k over 60 users at batch 8:
    7 full batches and a trailing partial one of 4."""
    n_user = 60
    tr = Trainer(cfg(eval_batches_per_call=k), n_user, N_ITEM)
    tn = NativeCSR.from_scipy(sp.csr_matrix(binary(1, n_user, 0.3)))
    gn = NativeCSR.from_scipy(sp.csr_matrix(binary(2, n_user, 0.1)))
    return tr, lambda: tr.evaluate_streaming(None, [tn], gn, [tn], [5, 10])


# K 3: groups of batches 0-2 and 3-5; batch 6 alone when the partial
# batch comes, then the partial batch alone
@pytest.mark.parametrize("k,groups,singles", [(1, 0, 8), (3, 2, 2)])
def test_evaluate_streaming_emits_a_span_per_batch_group_and_pass(
        k, groups, singles):
    tr, run = streaming_case(k)
    with profiled() as prof:
        run()
    want = {"gdmcf.eval.assemble": 8, "gdmcf.eval.ground_truth": 8,
            "gdmcf.eval.metrics": 8, "gdmcf.eval.fetch": 1}
    if groups:
        want["gdmcf.eval.group"] = groups
    if singles:
        want["gdmcf.eval.single"] = singles
    assert span_counts(prof) == want
    assert {n: t[0] for n, t in P.span_totals().items()} == want


def train_case(k, prefetch):
    """A Trainer at ``train_steps_per_call`` k over 30 rows at batch 8: 3
    full batches and a trailing partial one of 6."""
    rows = binary(3, 30, 0.25)
    tr = Trainer(cfg(train_steps_per_call=k, prefetch_batches=prefetch),
                 30, N_ITEM)
    state = tr.init_state()
    return tr, state, DiffusionDataset.from_rows(rows)


# K 2: batches 0-1 a group; batch 2 alone when the partial batch comes,
# then the partial batch alone. Prefetch: one wait a batch and one for the
# end of the stream.
@pytest.mark.parametrize("prefetch", [0, 2])
def test_train_epoch_emits_a_span_per_batch_group_step_and_epoch(prefetch):
    tr, state, data = train_case(2, prefetch)
    with profiled() as prof:
        state, total = tr.train_epoch(state, data, np.random.default_rng(0))
    assert np.isfinite(total) and state.step == 4
    want = {"gdmcf.train.group": 1, "gdmcf.train.single": 2,
            "gdmcf.train.loss_fetch": 1}
    if prefetch:
        want["gdmcf.prefetch.wait"] = 4 + 1
    assert span_counts(prof) == want
    assert {n: t[0] for n, t in P.span_totals().items()} == want


def _train_result(profiler_on: bool):
    tr, state, data = train_case(2, 2)
    with (profile() if profiler_on else contextlib.nullcontext()):
        totals = []
        for epoch in range(2):
            state, total = tr.train_epoch(state, data,
                                          np.random.default_rng(epoch))
            totals.append(total)
    return totals, {k: p.detach().clone() for k, p in state.params.items()}


def _eval_result(monkeypatch, profiler_on: bool):
    """The rounded metrics and the accumulator's unrounded sums."""
    from gdmcf_torch.ops.metrics import MetricAccumulator

    tr, run = streaming_case(3)
    sums, result = [], MetricAccumulator.result

    def keep(acc):
        out = result(acc)
        sums.append(acc.sums.copy())
        return out
    monkeypatch.setattr(MetricAccumulator, "result", keep)
    with (profile() if profiler_on else contextlib.nullcontext()):
        got = run()
    monkeypatch.undo()
    return got, sums


@pytest.mark.parametrize("what", ["train", "eval"])
def test_results_are_bitwise_equal_with_the_profiler_on_and_off(
        monkeypatch, what):
    if what == "train":
        (t0, p0), (t1, p1) = _train_result(False), _train_result(True)
        assert t0 == t1
        assert p0.keys() == p1.keys()
        for k in p0:
            assert torch.equal(p0[k], p1[k]), k
    else:
        (r0, s0), (r1, s1) = (_eval_result(monkeypatch, False),
                              _eval_result(monkeypatch, True))
        assert r0 == r1
        assert len(s0) == len(s1) == 1 and np.array_equal(s0[0], s1[0])
