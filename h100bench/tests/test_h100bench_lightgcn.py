"""The LightGCN pretraining cell on the CPU at a tiny size: the program's
steps against the plain reference (``reference/lightgcn.py``) under the
cell's checks, whole runs of a tiny copy of the cell, sound and with the
program broken underneath (each planted fault must make ``correct``
false), the bfloat16 control outside the limits, the per-layer readers,
and the SpMM's byte count pinned to PERF.md's kernel table.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from h100bench import costs_lightgcn as C
from h100bench import harness as H
from h100bench import tracing as T
from h100bench.costs import HBM_BYTES_PER_S
from h100bench.reference import lightgcn as R

REPO = Path(__file__).resolve().parents[2]
CELL = "lightgcn1m-pretrain"
LIMITS = json.loads(
    (REPO / f"h100bench/workloads/{CELL}.json").read_text())["checks"]
# 256 x 200 pads both operands to 256 output rows (tiles of 8 x 128), so
# the directions swapped still give tables of the right shapes
TINY = {"n_user": 256, "n_item": 200, "edges": 3000, "dim": 16,
        "batch": 64}


def make_tiny_pretrain(dst: Path) -> Path:
    """A copy of the benchmark's cell files under ``dst`` with the tiny
    configuration ``tiny_lightgcn`` and its cell ``tiny-pretrain``."""
    from conftest import make_tiny

    root = make_tiny(dst)
    conf = json.loads((root / "configs/lightgcn_1m.json").read_text())
    conf.update(name="tiny_lightgcn", n_user=TINY["n_user"],
                n_item=TINY["n_item"],
                graph={"kind": "power_law", "n_edges": TINY["edges"]},
                params=(TINY["n_user"] + TINY["n_item"]) * TINY["dim"])
    conf["recipe"].update(latent_dim=TINY["dim"], batch_size=TINY["batch"])
    (root / "configs/tiny_lightgcn.json").write_text(json.dumps(conf))
    wl = json.loads((root / f"workloads/{CELL}.json").read_text())
    wl.update(name="tiny-pretrain", config="tiny_lightgcn")
    wl["traffic"].update(warmup_steps=3, chunk_steps=2)
    (root / "workloads/tiny-pretrain.json").write_text(json.dumps(wl))
    bench_file = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    bench["workloads"].append({"name": "tiny-pretrain",
                               "config": "tiny_lightgcn",
                               "traffic": "bpr_steps", "chips": 1,
                               "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny-pretrain")
    bench_file.write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Path:
    return make_tiny_pretrain(tmp_path_factory.mktemp("tinylgn"))


def run_tiny(root, seed=2 ** 33 + 5, trace=False):
    from h100bench.run import run_cell

    return run_cell("tiny-pretrain", seed, 0.3, trace, device="cpu",
                    root=root)


def test_a_sound_run_is_correct_and_reports_the_cells_metrics(tiny):
    out = run_tiny(tiny)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "train_examples_per_s"}
    assert out["failed"] == 0 and out["attempted"] >= 8
    assert list(out["checks"]) == ["loss_gap", "grad_gap", "change_gap",
                                   "triples_valid"]
    c = out["checks"]
    # the same float32 sums in another order, at a tiny size
    assert c["loss_gap"]["value"] < 1e-6 and c["grad_gap"]["value"] < 1e-5
    assert c["change_gap"]["value"] < 1e-3
    assert c["triples_valid"]["value"] == 0


def _swapped(inner):
    def prop(e_user, e_item, fwd, t, n_layers):
        return inner(e_user, e_item, t, fwd, n_layers)
    return prop


def _dropped(inner):
    def prop(e_user, e_item, fwd, t, n_layers):
        return inner(e_user, e_item, fwd, t, n_layers - 1)
    return prop


def _last_layer(inner):
    def layers(e_user, e_item, n_layers, fwd, bwd):
        n_user, n_item = e_user.shape[0], e_item.shape[0]
        u, i = e_user, e_item
        for _ in range(n_layers):
            u, i = fwd(i)[:n_user], bwd(u)[:n_item]
        return u, i
    return layers


def _lr_zero(inner):
    def step(e0, opt, prop, batch, n_user, lr, decay):
        return inner(e0, opt, prop, batch, n_user, 0.0, decay)
    return step


def _stale(inner):
    last = []

    def step(e0, opt, prop, batch, n_user, lr, decay):
        use = last[0] if last else batch
        last[:] = [batch]
        return inner(e0, opt, prop, use, n_user, lr, decay)
    return step


def _start_elsewhere(inner):
    def table(n_rows, dim, seed, device=None):
        return inner(n_rows, dim, seed + 1, device)
    return table


FAULTS = {"layer_dropped": ("propagate_rows", _dropped),
          "last_layer_not_mean": ("_layers", _last_layer),
          "directions_swapped": ("propagate_rows", _swapped),
          "lr_zero": ("bpr_step", _lr_zero),
          "stale_batch": ("bpr_step", _stale),
          "start_elsewhere": ("initial_table", _start_elsewhere)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_makes_the_run_not_correct(fault, tiny,
                                                      monkeypatch):
    from gdmcf_torch.models import lightgcn as LG

    name, plant = FAULTS[fault]
    monkeypatch.setattr(LG, name, plant(getattr(LG, name)))
    out = run_tiny(tiny)
    assert out["correct"] is False, (fault, out["checks"])


def test_an_invalid_triple_is_counted():
    csr = sp.csr_matrix(np.array([[1, 0, 1], [0, 1, 0]], np.float32))
    ok = np.array([[[0, 1], [2, 1], [1, 0]]])
    assert R.invalid_triples(csr, ok) == 0
    # user 0: positive 1 outside its row, negative 2 in it; user 1:
    # negative 1 in its row
    bad = np.array([[[0, 1], [1, 1], [2, 1]]])
    assert R.invalid_triples(csr, bad) == 3


def test_the_bfloat16_control_fails_a_limit(tiny):
    from h100bench import control_lightgcn

    cell = H.find_cell("tiny-pretrain", tiny)
    got = control_lightgcn.readings(cell, 7, "cpu")["control"]
    assert got["triples_valid"] == 0
    assert any(got[k] > LIMITS[k] for k in LIMITS), got


@pytest.mark.gpu
def test_the_bfloat16_control_fails_a_limit_at_the_cells_size(card):
    from h100bench import control_lightgcn

    got = control_lightgcn.readings(H.find_cell(CELL), 3004, card)
    assert any(got["control"][k] > LIMITS[k] for k in LIMITS), got


def test_the_references_start_table_is_the_programs():
    from gdmcf_torch.models import lightgcn as LG

    for seed in (7, 2 ** 31 + 11):
        np.testing.assert_array_equal(
            R.initial_table(seed, 456, 16),
            LG.initial_table(456, 16, seed, "cpu").numpy())


def test_the_reference_follows_the_programs_steps(tiny):
    """The port's pretrainer and the reference on the same triples from
    the same table, step by step, at 300 x 200, D 16, 8 steps."""
    from gdmcf_torch.models import lightgcn as LG
    from h100bench import data as D
    from h100bench.drivers import bpr_pretrain as drv

    csr = D.graph({"kind": "power_law", "n_edges": 3000}, 300, 200, 11)
    rc = dict(n_layers=3, lr=1e-3, decay=1e-4)
    pt = LG.BPRPretrainer(csr, latent_dim=16, batch_size=64, seed=11,
                          sparse="hybrid", device="cpu", **rc)
    start = pt.e0.detach().clone()
    losses = pt.steps(8).tolist()
    ref = drv.reference_steps(csr, start.numpy(), pt.recent(8), rc, "cpu")
    gaps = [abs(a - b) / b for a, b in zip(losses, ref.losses)]
    assert max(gaps) < 1e-6, gaps
    assert drv.rel_norm(pt.e0.detach() - start, ref.e0 - start) < 1e-3


def test_the_readers_read_the_trace_and_counters(tiny):
    cell = H.find_cell("tiny-pretrain", tiny)
    ctx = H.Context(cell=cell, seed=1, seconds=1.0, trace=True,
                    device="cpu", clock=H.SetupClock(), root=tiny)
    tr = T.TraceSummary(
        window_s=2.0, busy_s=1.6,
        ops={"void spmm_rows_kernel<true>(int const*)": 1.2,
             "triton_poi__adamw_kernel_0d1": 0.2, "elementwise": 0.2})
    counters = {"steps": 100, "window_s": 2.0, "params": 1000,
                "spmm_rows_fwd_launches": 600, "spmm_rows_t_launches": 600,
                "spmm_rows_fwd_bytes": 3e6, "spmm_rows_t_bytes": 4e6}
    res = H.DriverResult(e2e={}, counters=counters, checks={},
                         attempted=100, failed=0, memory_peak_bytes=0,
                         setup_s=1.0, trace=tr)
    m = H.result_line(ctx, res, {"platform": "gpu", "kind": "x",
                                 "count": 1})["metrics"]
    assert m["spmm_rows_roofline.pretrain"]["value"] == pytest.approx(
        100 * 600 * 7e6 / 3.35e12 / 1.2)
    assert m["k1_adamw_roofline.pretrain"]["value"] == pytest.approx(
        100 * (28 * 1000 / 3.35e12) / (0.2 / 100))
    assert m["spmm_share.pretrain"]["value"] == pytest.approx(75.0)
    assert m["device_idle.pretrain"]["value"] == pytest.approx(20.0)
    for name in ("spmm_rows_roofline.pretrain", "k1_adamw_roofline.pretrain",
                 "spmm_share.pretrain", "device_idle.pretrain",
                 "bpr_sample_ms.pretrain"):
        assert H.metric_reader(name, tiny).read(
            {"trace": None, "counters": {}}) is None


def test_a_traced_run_reports_the_span_reader(tiny):
    out = run_tiny(tiny, trace=True)
    assert out["correct"] is True
    # the CPU puts nothing on a device timeline: the readers of the
    # device's trace stay silent, the span's reader reads
    assert set(out["metrics"]) == {"bpr_sample_ms.pretrain"}
    assert out["metrics"]["bpr_sample_ms.pretrain"]["value"] > 0


def _synthetic_csr(rng, n_user, n_item, avg_degree, alpha):
    # benchmarks/scale_smoke.py's generator, the graph of the kernel
    # table's 1M x 200k operand
    pop = 1.0 / np.arange(1, n_item + 1) ** alpha
    pop /= pop.sum()
    degrees = np.maximum(rng.poisson(avg_degree, n_user), 1)
    rows = np.repeat(np.arange(n_user), degrees)
    cols = rng.choice(n_item, size=degrees.sum(), p=pop)
    m = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                      shape=(n_user, n_item))
    m.data[:] = 1.0
    return m


def test_the_spmm_byte_count_is_the_kernel_tables():
    """At the 1M x 200k operand of the kernel table (seed 0, degree 10,
    alpha 1.6, degree-sorted, N over the hybrid's padded grid) the bound
    is 0.0952 ms forward and 0.1056 ms transposed at D 64."""
    from gdmcf_torch.models import lightgcn as LG
    from gdmcf_torch.ops import spmm as S

    m = _synthetic_csr(np.random.default_rng(0), 1_000_000, 200_000, 10,
                       1.6)
    rp, cp = S.degree_sort_permutation(m)
    m = m.tocsr()[rp][:, cp].tocsr()
    assert m.nnz == 5_462_313
    n, _ = LG._normalized_sparse_n(m, 1e-9, False)
    n = sp.csr_matrix(n, shape=(1_000_000, 200_064))
    fwd, t = S.row_operands(n)
    ms = [round(C.spmm_bytes(C.operand_counts(op), 64) / HBM_BYTES_PER_S
                * 1e3, 4) for op in (fwd, t)]
    assert ms == [0.0952, 0.1056]
    assert C.adamw_bound_s(76_800_000) == pytest.approx(
        28 * 76.8e6 / 3.35e12)


def test_the_cell_sets_its_limits_and_the_configuration_its_numbers():
    conf = json.loads((REPO / "h100bench/configs/lightgcn_1m.json")
                      .read_text())
    assert conf["reduced"] == [] and set(conf["assumed"]) == {
        "graph", "operand", "steps_per_epoch", "weights"}
    assert conf["params"] == (conf["n_user"] + conf["n_item"]) \
        * conf["recipe"]["latent_dim"]
    assert set(LIMITS) == {"loss_gap", "grad_gap", "change_gap",
                           "triples_valid"}
    assert LIMITS["triples_valid"] == 0
