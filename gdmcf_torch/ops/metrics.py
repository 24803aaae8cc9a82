"""Ranking metrics: Precision/Recall/NDCG/MRR @ K over [N, K] hit matrices.

Port of the JAX package's ``ops/metrics.py``, with the same semantics,
including its quirks:

  * users with empty ground truth contribute 0 to every numerator but are
    still counted in the denominator;
  * IDCG@k truncates at min(k, |GT|);
  * NDCG is added only when IDCG != 0;
  * MRR uses the first hit within the cutoff;
  * results round to 4 decimals.

Sums are float32 per batch (as in the JAX package) and combine in float64
on the host, once per evaluation.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from gdmcf_torch.ops.bitpack import is_binary, pack_rows, unpack_rows


def _as_tensor(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device or "cpu")


def _rounded(out: np.ndarray):
    rnd = lambda row: [round(float(v), 4) for v in row]  # noqa: E731
    return rnd(out[0]), rnd(out[1]), rnd(out[2]), rnd(out[3])


def _metrics_sums(hits: torch.Tensor, gt_count: torch.Tensor,
                  topn: Tuple[int, ...]) -> torch.Tensor:
    """hits [N, K_max] {0,1} float32, gt_count [N] float32 -> [4, len(topn)]
    metric SUMS (divide by the user count for the means), so evaluation can
    stream batch by batch."""
    k_max = hits.shape[1]
    dev = hits.device
    disc = 1.0 / torch.log2(torch.arange(k_max, dtype=torch.float32,
                                         device=dev) + 2.0)
    cum_disc = torch.cumsum(disc, 0)   # cum_disc[j] = sum_{i<=j} 1/log2(i+2)
    valid = (gt_count > 0).float()
    zero = hits.new_zeros(())
    cols = []
    for k in topn:
        hk = hits[:, :k]
        user_hits = hk.sum(dim=1)
        precision = (user_hits / k) * valid
        recall = torch.where(gt_count > 0,
                             user_hits / torch.clamp_min(gt_count, 1), zero)
        dcg = (hk * disc[:k]).sum(dim=1)
        idcg_len = torch.clamp_max(gt_count, k).long()
        idcg = torch.where(idcg_len > 0,
                           cum_disc[torch.clamp_min(idcg_len - 1, 0)], zero)
        ndcg = torch.where(idcg > 0, dcg / torch.clamp_min(idcg, 1e-12),
                           zero) * valid
        first_hit = torch.argmax(hk, dim=1)   # the first maximum
        has_hit = hk.any(dim=1)
        mrr = torch.where(has_hit, 1.0 / (first_hit + 1.0), zero) * valid
        cols.append(torch.stack([precision.sum(), recall.sum(), ndcg.sum(),
                                 mrr.sum()]))
    return torch.stack(cols, dim=1)


def _check_cutoff(topn: Tuple[int, ...], ranked: int) -> None:
    if max(topn) > ranked:
        raise ValueError(
            f"topn cutoff {max(topn)} exceeds the {ranked} ranked "
            "predictions — rank at least max(topn) items per user")


def _hits_and_counts(gt_rows, pred_idx, topn: Tuple[int, ...]):
    """Hit matrix [N, K] and ground-truth counts [N] (float32). Ground
    truth is MEMBERSHIP (``!= 0``): count-valued cells binarize, as the
    reference tests ``pred in GroundTruth[i]``. Fails loudly when fewer
    items were ranked than the largest cutoff asks for."""
    idx = _as_tensor(pred_idx).long()
    gt = _as_tensor(gt_rows, idx.device) != 0
    _check_cutoff(topn, idx.shape[1])
    hits = torch.gather(gt, 1, idx).float()
    return hits, gt.sum(dim=1).float()


def compute_topn_accuracy(
    gt_matrix,       # [N, n_item] ground truth, numpy or tensor
    pred_indices,    # [N, K_max] ranked item ids
    topn: Sequence[int],
) -> Tuple[List[float], List[float], List[float], List[float]]:
    """The reference ``computeTopNAccuracy``: (precision, recall, NDCG,
    MRR) lists rounded to 4 decimals."""
    topn = tuple(topn)
    hits, gt_count = _hits_and_counts(gt_matrix, pred_indices, topn)
    sums = _metrics_sums(hits, gt_count, topn).cpu().numpy()
    return _rounded(sums / hits.shape[0])


def packed_batch_metric_sums(gt_packed: torch.Tensor, idx: torch.Tensor,
                             n_item: int,
                             topn: Tuple[int, ...]) -> torch.Tensor:
    """Metric sums on the rankings' device from a BIT-PACKED ground-truth
    batch: gt_packed [B, ceil(n_item/8)] uint8 and idx [B, K] -> [4,
    len(topn)] float32, or [G, B, ...] and [G, B, K] -> [G, 4, len(topn)].
    Nothing leaves the device; the same math as ``_metrics_sums``."""
    topn = tuple(topn)
    _check_cutoff(topn, idx.shape[-1])

    def one(gp, ix):
        gt = unpack_rows(gp, n_item)
        hits = torch.gather(gt, 1, ix.long())
        return _metrics_sums(hits, gt.sum(dim=1), topn)

    gt_packed = _as_tensor(gt_packed, idx.device)
    if gt_packed.ndim == 3:
        return torch.stack([one(g, i) for g, i in zip(gt_packed, idx)])
    return one(gt_packed, idx)


class MetricAccumulator:
    """Streamed Precision/Recall/NDCG/MRR: feed (gt_rows, pred_idx) batches,
    read the reference-equivalent means at the end. Sums accumulate
    unrounded and divide once.

    The device path's per-batch sums stay on the device until
    :meth:`result`, which fetches them in one transfer: a fetch per batch
    would wait for every batch."""

    def __init__(self, topn: Sequence[int]):
        self.topn = tuple(topn)
        self.sums = np.zeros((4, len(self.topn)), dtype=np.float64)
        self._pending: List[torch.Tensor] = []
        self.n_users = 0

    def add(self, gt_rows, pred_idx, binary: "bool | None" = None) -> None:
        """``binary``: the dataset-level verdict when the caller knows it,
        to skip the O(B*n_item) host scan."""
        if isinstance(gt_rows, torch.Tensor):
            gt_rows = gt_rows.cpu().numpy()
        g = np.asarray(gt_rows)
        if g.ndim == 2 and g.size and (is_binary(g) if binary is None
                                       else binary):
            # binary ground truth (the normal case) ships as bits
            self.add_packed(pack_rows(g), pred_idx, g.shape[1])
            return
        hits, gt_count = _hits_and_counts(g, pred_idx, self.topn)
        self.sums += _metrics_sums(hits, gt_count,
                                   self.topn).cpu().numpy().astype(np.float64)
        self.n_users += hits.shape[0]

    def add_packed(self, gt_packed, pred_idx, n_item: int) -> None:
        """gt ships bit-packed, pred_idx stays where it is (a device tensor
        is never fetched); the [4, n] sums are fetched at :meth:`result`."""
        idx = _as_tensor(pred_idx)
        sums = packed_batch_metric_sums(gt_packed, idx, n_item, self.topn)
        if sums.ndim == 3:   # a group [G, 4, n] counts G*B users
            sums = sums.sum(dim=0)
            self.n_users += int(idx.shape[0] * idx.shape[1])
        else:
            self.n_users += int(idx.shape[0])
        self._pending.append(sums)

    def _drain(self) -> None:
        if self._pending:
            # one stacked fetch for the whole evaluation
            self.sums += torch.stack(self._pending).cpu().numpy().astype(
                np.float64).sum(axis=0)
            self._pending.clear()

    def result(self):
        self._drain()
        return _rounded(self.sums / max(self.n_users, 1))


def _lightgcn_sums(hits: torch.Tensor, gt_count: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Metric sums of the LightGCN pretrainer's protocol, which differs
    from ``compute_topn_accuracy``: NDCG discounts with the natural log;
    MAP@K = sum(cumhits[i] * hit[i] / (i + 1)) / |GT|; users without
    ground truth count in neither numerator nor denominator. Returns [5]:
    the sums of (recall, precision, ndcg, map) over valid users and the
    valid-user count."""
    hk = hits[:, :k]
    dev = hk.device
    disc = 1.0 / torch.log(torch.arange(k, dtype=torch.float32, device=dev)
                           + 2.0)
    cum_disc = torch.cumsum(disc, 0)
    valid = (gt_count > 0).float()
    safe_gt = torch.clamp_min(gt_count, 1.0)
    user_hits = hk.sum(dim=1)
    recall = user_hits / safe_gt
    precision = user_hits / k
    dcg = (hk * disc).sum(dim=1)
    idcg_len = torch.clamp_max(gt_count, k).long()
    idcg = cum_disc[torch.clamp_min(idcg_len - 1, 0)]
    ndcg = dcg / torch.clamp_min(idcg, 1e-12)
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=dev)
    ap = (torch.cumsum(hk, dim=1) * hk / ranks).sum(dim=1) / safe_gt
    return torch.stack([(recall * valid).sum(), (precision * valid).sum(),
                        (ndcg * valid).sum(), (ap * valid).sum(),
                        valid.sum()])


def lightgcn_topn_metrics(gt_matrix, pred_indices,
                          k: int) -> Tuple[float, float, float, float]:
    """(recall, precision, ndcg, map)@k means over the users with ground
    truth, the reference LightGCN pretrainer's ``get_metrics``. gt_matrix
    [N, n_item] and pred_indices [N, >= k] ranked item ids, numpy or
    tensors; computed where pred_indices lies, one fetch."""
    hits, gt_count = _hits_and_counts(gt_matrix, pred_indices, (k,))
    s = _lightgcn_sums(hits, gt_count, k).cpu().numpy().astype(np.float64)
    n = max(s[4], 1.0)
    return (float(s[0] / n), float(s[1] / n), float(s[2] / n),
            float(s[3] / n))


def print_results(loss, valid_result, test_result) -> None:
    """Human-readable metric lines (the reference's format)."""
    if loss is not None:
        print("[Train]: loss: {:.4f}".format(loss))
    for tag, res in (("Valid", valid_result), ("Test", test_result)):
        if res is not None:
            print("[{}]: Precision: {} Recall: {} NDCG: {} MRR: {}".format(
                tag,
                "-".join(str(x) for x in res[0]),
                "-".join(str(x) for x in res[1]),
                "-".join(str(x) for x in res[2]),
                "-".join(str(x) for x in res[3])))
