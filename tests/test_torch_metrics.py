"""The port's ranking metrics, synthetic data and metric logger against the
JAX package's.

Tolerances: the metric lists are compared exactly (both packages sum in
float32 per batch and round to 4 decimals; seeded inputs put no sum on a
rounding boundary). Raw float32 sums: rtol 1e-6. The synthetic dataset's
files: byte for byte.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gdmcf_torch.data import loader as TLoad  # noqa: E402
from gdmcf_torch.ops import metrics as TM  # noqa: E402
from gdmcf_torch.ops.bitpack import pack_rows  # noqa: E402
from gdmcf_torch.utils.logging import MetricLogger  # noqa: E402
from gdmcf_tpu.data import loader as JLoad  # noqa: E402
from gdmcf_tpu.ops import metrics as JM  # noqa: E402
from gdmcf_tpu.utils.logging import MetricLogger as JMetricLogger  # noqa: E402


def rankings(seed, n_users=150, n_item=120, k_max=50, density=0.06,
             counts=False, empty=(3, 17)):
    """Seeded ground truth (binary, or count-valued cells up to 3) and
    rankings [N, k_max] of distinct item ids."""
    rng = np.random.default_rng(seed)
    gt = (rng.random((n_users, n_item)) < density).astype(np.float32)
    if counts:
        gt *= rng.integers(1, 4, gt.shape)
    gt[list(empty)] = 0.0   # empty ground truth: counted in the denominator
    pred = np.argsort(-rng.random((n_users, n_item)), axis=1)[:, :k_max]
    return gt, pred.astype(np.int64)


def oracle(gt, pred, topn):
    """Per-user Python loop with the reference's conventions."""
    out = [[], [], [], []]
    for k in topn:
        p = r = nd = mr = 0.0
        for i in range(len(pred)):
            gts = set(np.nonzero(gt[i])[0].tolist())
            if not gts:
                continue
            hits = [int(pred[i][j]) in gts for j in range(k)]
            dcg = sum(1.0 / math.log2(j + 2) for j in range(k) if hits[j])
            idcg = sum(1.0 / math.log2(j + 2)
                       for j in range(min(k, len(gts))))
            p += sum(hits) / k
            r += sum(hits) / len(gts)
            nd += dcg / idcg if idcg else 0.0
            mr += 1.0 / (hits.index(True) + 1) if any(hits) else 0.0
        for row, v in zip(out, (p, r, nd, mr)):
            row.append(round(v / len(pred), 4))
    return tuple(out)


@pytest.mark.parametrize("seed,counts,topn", [
    (0, False, [10, 20, 50]), (1, True, [10, 20, 50]),
    (2, False, [50, 5, 20]), (3, True, [1, 7]), (4, False, [20])])
def test_compute_topn_accuracy_matches_jax(seed, counts, topn):
    gt, pred = rankings(seed, counts=counts)
    got = TM.compute_topn_accuracy(gt, pred, topn)
    assert got == tuple(JM.compute_topn_accuracy(gt, pred, topn))
    for g_row, o_row in zip(got, oracle(gt, pred, topn)):
        np.testing.assert_allclose(g_row, o_row, atol=1.5e-4)
    # tensors in, same answer
    assert TM.compute_topn_accuracy(torch.from_numpy(gt),
                                    torch.from_numpy(pred), topn) == got


@pytest.mark.parametrize("counts", [False, True])
def test_metric_sums_match_jax(counts):
    gt, pred = rankings(5, counts=counts)
    topn = (10, 20, 50)
    hits, cnt = TM._hits_and_counts(gt, pred, topn)
    jh, jc = JM._hits_and_counts(gt, pred, topn)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jc))
    np.testing.assert_allclose(TM._metrics_sums(hits, cnt, topn).numpy(),
                               np.asarray(JM._metrics_sums(jh, jc, topn)),
                               rtol=1e-6)


def test_packed_sums_and_accumulator_equal_the_one_shot_form():
    gt, pred = rankings(6, n_users=160)
    topn = (10, 20, 50)
    n_item = gt.shape[1]
    want = TM.compute_topn_accuracy(gt, pred, topn)
    jsums = np.asarray(JM.packed_batch_metric_sums(
        pack_rows(gt[:40]), pred[:40], n_item, topn))
    sums = TM.packed_batch_metric_sums(torch.from_numpy(pack_rows(gt[:40])),
                                       torch.from_numpy(pred[:40]), n_item,
                                       topn)
    np.testing.assert_allclose(sums.numpy(), jsums, rtol=1e-6)
    # a fused group [G, B, ...] gives one [4, n] per member
    grouped = TM.packed_batch_metric_sums(
        torch.from_numpy(pack_rows(gt[:80]).reshape(2, 40, -1)),
        torch.from_numpy(pred[:80].reshape(2, 40, -1)), n_item, topn)
    assert grouped.shape == (2, 4, 3)
    torch.testing.assert_close(grouped[0], sums, rtol=0, atol=0)

    acc = TM.MetricAccumulator(topn)
    jacc = JM.MetricAccumulator(topn)
    for lo, hi in ((0, 40), (40, 55), (55, 160)):   # uneven batches
        acc.add(gt[lo:hi], pred[lo:hi])
        jacc.add(gt[lo:hi], pred[lo:hi])
    assert acc.n_users == 160 and len(acc._pending) == 3
    assert acc.result() == want == jacc.result()

    # a fused group sums in another float32 order: a mean that lies exactly
    # on a 4-decimal boundary (precision@10 is 86/1600 = 0.05375 here) may
    # round either way, so the unrounded sums are held to rtol 1e-6
    acc = TM.MetricAccumulator(topn)
    acc.add_packed(pack_rows(gt[:80]).reshape(2, 40, -1),
                   torch.from_numpy(pred[:80].reshape(2, 40, -1)), n_item)
    acc.add_packed(torch.from_numpy(pack_rows(gt[80:])),
                   torch.from_numpy(pred[80:]), n_item)
    got = acc.result()
    hits, cnt = TM._hits_and_counts(gt, pred, topn)
    np.testing.assert_allclose(
        acc.sums, TM._metrics_sums(hits.double(), cnt.double(), topn),
        rtol=1e-6)
    assert acc.n_users == 160
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 + 1e-9)


def test_accumulator_host_path_for_count_valued_ground_truth():
    gt, pred = rankings(7, counts=True)
    topn = (10, 20)
    acc = TM.MetricAccumulator(topn)
    acc.add(gt[:70], pred[:70])
    acc.add(gt[70:], pred[70:], binary=False)
    assert not acc._pending   # summed on the host, not packed
    assert acc.result() == TM.compute_topn_accuracy(gt, pred, topn)


def test_cutoff_wider_than_the_ranking_fails_loudly():
    gt, pred = rankings(8, k_max=10)
    with pytest.raises(ValueError, match="exceeds the 10 ranked"):
        TM.compute_topn_accuracy(gt, pred, [20])
    with pytest.raises(ValueError, match="exceeds the 10 ranked"):
        TM.MetricAccumulator([5, 20]).add(gt, pred)
    with pytest.raises(ValueError, match="exceeds the 10 ranked"):
        TM.packed_batch_metric_sums(torch.from_numpy(pack_rows(gt)),
                                    torch.from_numpy(pred), gt.shape[1],
                                    (20,))


def test_print_results_format(capsys):
    res = ([0.1, 0.05], [0.2, 0.3], [0.15, 0.1724], [0.3, 0.31])
    TM.print_results(1.23456, res, None)
    TM.print_results(None, None, res)
    got = capsys.readouterr().out
    JM.print_results(1.23456, res, None)
    JM.print_results(None, None, res)
    assert got == capsys.readouterr().out
    assert "[Valid]: Precision: 0.1-0.05 Recall: 0.2-0.3" in got


@pytest.mark.parametrize("kw", [
    dict(n_user=60, n_item=40, avg_degree=6, seed=0),
    dict(n_user=90, n_item=70, avg_degree=9, seed=3, valid_frac=0.2,
         test_frac=0.1, alpha=0.9)])
def test_generate_synthetic_dataset_writes_the_jax_files(tmp_path, kw):
    got = TLoad.generate_synthetic_dataset(str(tmp_path / "t"), **kw)
    want = JLoad.generate_synthetic_dataset(str(tmp_path / "j"), **kw)
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()
    tr, va, te, n_user, n_item = TLoad.data_load_dir(str(tmp_path / "t"))
    assert (n_user, n_item) == (kw["n_user"], kw["n_item"])


@pytest.mark.parametrize("text", [True, False])
def test_metric_logger_writes_the_jax_files(tmp_path, capsys, text):
    for cls, sub in ((MetricLogger, "t"), (JMetricLogger, "j")):
        lg = cls(str(tmp_path / sub), echo=True, text=text)
        lg.log("Runing Epoch 001 train loss 1.0000 costs 00: 00: 01")
        lg.metrics(1, train_loss=1.0)
        lg.eval_results(1, "valid", [10, 20],
                        ([0.1, 0.2], [0.3, 0.4], [0.5, 0.6], [0.7, 0.8]))
        lg.close()
    out = capsys.readouterr().out
    assert out.count("Runing Epoch 001") == 2
    files = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert ("output_NDCG.txt" in files) == text
    for name in files:
        lines = [(tmp_path / s / name).read_text().splitlines()
                 for s in ("t", "j")]
        if name.endswith(".jsonl"):
            lines = [[{k: v for k, v in json.loads(x).items() if k != "time"}
                      for x in side] for side in lines]
        assert lines[0] == lines[1]
