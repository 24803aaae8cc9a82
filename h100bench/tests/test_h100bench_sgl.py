"""The SGL-ED pretraining cell on the CPU at a tiny size: whole runs of a
tiny copy of the cell, sound and with the program broken underneath (each
planted fault must make ``correct`` false), the bfloat16 control outside
the limits, the view checks' count, the per-layer readers, and the cost
functions.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from h100bench import costs_sgl as CS
from h100bench import harness as H
from h100bench import tracing as T
from h100bench.reference import sgl as RS

REPO = Path(__file__).resolve().parents[2]
CELL = "sgl1m-pretrain"
LIMITS = json.loads(
    (REPO / f"h100bench/workloads/{CELL}.json").read_text())["checks"]
# as the LightGCN cell's tiny copy: 256 x 200 pads both operands to 256
# output rows
TINY = {"n_user": 256, "n_item": 200, "edges": 3000, "dim": 16,
        "batch": 64}


def make_tiny_sgl(dst: Path) -> Path:
    """A copy of the benchmark's cell files under ``dst`` with the tiny
    configuration ``tiny_sgl`` and its cell ``tiny-sgl``."""
    from conftest import make_tiny

    root = make_tiny(dst)
    conf = json.loads((root / "configs/sgl_1m.json").read_text())
    conf.update(name="tiny_sgl", n_user=TINY["n_user"],
                n_item=TINY["n_item"],
                graph={"kind": "power_law", "n_edges": TINY["edges"]},
                params=(TINY["n_user"] + TINY["n_item"]) * TINY["dim"])
    conf["recipe"].update(latent_dim=TINY["dim"], batch_size=TINY["batch"])
    (root / "configs/tiny_sgl.json").write_text(json.dumps(conf))
    wl = json.loads((root / f"workloads/{CELL}.json").read_text())
    wl.update(name="tiny-sgl", config="tiny_sgl")
    wl["traffic"].update(warmup_steps=3, chunk_steps=2)
    (root / "workloads/tiny-sgl.json").write_text(json.dumps(wl))
    bench_file = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    bench["workloads"].append({"name": "tiny-sgl", "config": "tiny_sgl",
                               "traffic": "sgl_steps", "chips": 1,
                               "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny-sgl")
    bench_file.write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Path:
    return make_tiny_sgl(tmp_path_factory.mktemp("tinysgl"))


def run_tiny(root, seed=2 ** 33 + 7, trace=False):
    from h100bench.run import run_cell

    return run_cell("tiny-sgl", seed, 0.3, trace, device="cpu", root=root)


def test_a_sound_run_is_correct_and_reports_the_cells_metrics(tiny):
    out = run_tiny(tiny)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "train_examples_per_s"}
    assert out["failed"] == 0 and out["attempted"] >= 8
    assert list(out["checks"]) == ["loss_gap", "grad_gap", "change_gap",
                                   "triples_valid", "views_valid"]
    c = out["checks"]
    # the same float32 sums in another order, at a tiny size
    assert c["loss_gap"]["value"] < 1e-6 and c["grad_gap"]["value"] < 1e-5
    assert c["change_gap"]["value"] < 1e-4
    assert c["triples_valid"]["value"] == c["views_valid"]["value"] == 0


# planted faults: each wraps a function of the program


def _in_batch(inner):
    """SimGCL's shortcut: the denominator over the batch's keys only."""
    def info_nce(q, keys, pos, temp, chunk):
        import torch

        loss, dq, dk_b, n = inner(q, keys[pos], torch.arange(len(pos)),
                                  temp, chunk)
        dk = torch.zeros_like(keys)
        dk.index_put_((pos,), dk_b, accumulate=True)
        return loss, dq, dk, n
    return info_nce


def _keys_constant(inner):
    """The view-2 denominators' gradient dropped: keys as constants."""
    def info_nce(q, keys, pos, temp, chunk):
        loss, dq, dk, n = inner(q, keys, pos, temp, chunk)
        return loss, dq, dk * 0, n
    return info_nce


def _view1_twice(inner):
    """View 1's propagator in view 2's place in the InfoNCE."""
    def term(self, *a):
        props = self.props
        self.props = (props[0], props[0])
        try:
            return inner(self, *a)
        finally:
            self.props = props
    return term


def _ssl_zero(inner):
    def init(self, train_csr, build, reg, *a):
        inner(self, train_csr, build, 0.0, *a)
    return init


def _lr_zero(inner):
    def step(e0, opt, prop, batch, n_user, lr, *a):
        return inner(e0, opt, prop, batch, n_user, 0.0, *a)
    return step


def _stale(inner):
    last = []

    def step(e0, opt, prop, batch, *a):
        use = last[0] if last else batch
        last[:] = [batch]
        return inner(e0, opt, prop, use, *a)
    return step


def _full_degrees(inner):
    """A view's kept cells normalized on the whole graph's degrees (at
    the cell's 3 layers)."""
    def propagator(self, kept):
        from gdmcf_torch.models import lightgcn as LG
        from gdmcf_torch.models import sgl
        from gdmcf_torch.ops import spmm

        csr = self.csr
        du, di = LG._inv_sqrt_degrees(csr.astype(np.float32), 1e-9)
        n = (sp.diags(du) @ sgl.view_csr(csr, kept) @ sp.diags(di)).tocoo()
        fwd, t = inner(self, kept).operands
        shape = (fwd.n_out, t.n_out)
        fwd, t = spmm.row_operands(sp.csr_matrix(
            (n.data.astype(np.float32), (n.row, n.col)), shape=shape))
        n_user = csr.shape[0]

        def prop(e0):
            return LG.propagate_rows(e0[:n_user], e0[n_user:], fwd, t, 3)
        prop.operands = (fwd, t)
        return prop
    return propagator


def _dropped(inner):
    def prop(e_user, e_item, fwd, t, n_layers):
        return inner(e_user, e_item, fwd, t, n_layers - 1)
    return prop


FAULTS = {"in_batch_denominators": ("sgl", "info_nce", _in_batch),
          "keys_constant": ("sgl", "info_nce", _keys_constant),
          "view1_twice": ("sgl", "Views.term", _view1_twice),
          "full_graph_degrees": ("sgl", "Views.propagator", _full_degrees),
          "ssl_reg_zero": ("sgl", "Views.__init__", _ssl_zero),
          "layer_dropped": ("lightgcn", "propagate_rows", _dropped),
          "lr_zero": ("lightgcn", "bpr_step", _lr_zero),
          "stale_batch": ("lightgcn", "bpr_step", _stale)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_makes_the_run_not_correct(fault, tiny,
                                                      monkeypatch):
    import importlib

    module, name, plant = FAULTS[fault]
    owner = importlib.import_module(f"gdmcf_torch.models.{module}")
    *path, name = name.split(".")
    for p in path:
        owner = getattr(owner, p)
    monkeypatch.setattr(owner, name, plant(getattr(owner, name)))
    out = run_tiny(tiny)
    assert out["correct"] is False, (fault, out["checks"])


def test_the_view_checks_count_what_they_name():
    csr = sp.csr_matrix((np.ones(10, np.float32),
                         (np.arange(10) % 4, np.arange(10))), shape=(4, 10))
    a, b = np.arange(9), np.arange(1, 10)
    assert RS.invalid_views(csr, [a, b], 0.1) == 0
    # the same view twice
    assert RS.invalid_views(csr, [a, a.copy()], 0.1) == 1
    # one short, one repeated, one out of the graph
    assert RS.invalid_views(csr, [a[:8], b], 0.1) == 1
    assert RS.invalid_views(csr, [np.r_[a[:8], 0], b], 0.1) == 1
    assert RS.invalid_views(csr, [np.r_[a[:8], 10], b], 0.1) == 1


def test_the_bfloat16_control_fails_a_limit(tiny):
    from h100bench import control_sgl

    cell = H.find_cell("tiny-sgl", tiny)
    got = control_sgl.readings(cell, 7, "cpu")["control"]
    assert got["triples_valid"] == got["views_valid"] == 0
    assert any(got[k] > LIMITS[k] for k in LIMITS), got


@pytest.mark.gpu
def test_the_bfloat16_control_fails_a_limit_at_the_cells_size(card):
    from h100bench import control_sgl

    got = control_sgl.readings(H.find_cell(CELL), 3004, card)
    assert any(got["control"][k] > LIMITS[k] for k in LIMITS), got


def _counters():
    c = {"steps": 100, "window_s": 2.0, "params": 1000, "dim": 64,
         "batch": 2048, "infonce_flops_per_step": CS.infonce_flops(
             2048, 64, 1000, 200), "view_build_s": 4.5}
    for i, name in enumerate(("n", "view1", "view2")):
        for d in ("fwd", "t"):
            k = f"spmm.{name}_{d}"
            c.update({f"{k}.launches": 600, f"{k}.slabbed": 0,
                      f"{k}.nnz": 10_000 - 1000 * i,
                      f"{k}.bytes": 1e6 * (i + 1)})
    return c


def test_the_readers_read_the_trace_and_counters(tiny):
    cell = H.find_cell("tiny-sgl", tiny)
    ctx = H.Context(cell=cell, seed=1, seconds=1.0, trace=True,
                    device="cpu", clock=H.SetupClock(), root=tiny)
    tr = T.TraceSummary(
        window_s=2.0, busy_s=1.6,
        ops={"void spmm_rows_kernel<true>(int const*)": 1.2,
             "sm90_xmma_gemm_f32f32": 0.2, "_adamw_kernel": 0.2})
    c = _counters()
    res = H.DriverResult(e2e={}, counters=c, checks={}, attempted=100,
                         failed=0, memory_peak_bytes=0, setup_s=1.0,
                         trace=tr)
    m = H.result_line(ctx, res, {"platform": "gpu", "kind": "x",
                                 "count": 1})["metrics"]
    flops = 100 * 6 * 2048 * 64 * 1200 + 600 * 2 * 64 * 2 * (
        10_000 + 9_000 + 8_000)
    assert m["train_mfu.sgl"]["value"] == pytest.approx(
        100 * flops / 2.0 / 495e12)
    assert m["spmm_rows_roofline.sgl"]["value"] == pytest.approx(
        100 * 600 * 2 * 6e6 / 3.35e12 / 1.2)
    assert m["spmm_share.sgl"]["value"] == pytest.approx(75.0)
    assert m["device_idle.sgl"]["value"] == pytest.approx(20.0)
    assert m["view_build_s.sgl"]["value"] == pytest.approx(4.5)
    # the LightGCN cell's K1 reader reads this cell's one pass a step
    assert m["k1_adamw_roofline.pretrain"]["value"] == pytest.approx(
        100 * 28 * 1000 / 3.35e12 / (0.2 / 100))
    for name in ("train_mfu.sgl", "spmm_rows_roofline.sgl",
                 "spmm_share.sgl", "device_idle.sgl", "view_build_s.sgl",
                 "k1_adamw_roofline.pretrain"):
        assert H.metric_reader(name, tiny).read(
            {"trace": None, "counters": {}}) is None


def test_a_traced_run_reports_the_view_reader(tiny):
    out = run_tiny(tiny, trace=True)
    assert out["correct"] is True
    # the CPU puts nothing on a device timeline: the readers of the
    # device's trace stay silent; the views' set-up phase and the
    # sampler's span read
    assert set(out["metrics"]) == {"view_build_s.sgl",
                                   "bpr_sample_ms.pretrain"}
    assert out["metrics"]["view_build_s.sgl"]["value"] > 0
    assert out["metrics"]["bpr_sample_ms.pretrain"]["value"] > 0


def test_the_least_flops_are_the_losses_products_and_the_spmms():
    assert CS.infonce_flops(2048, 64, 1_000_000, 200_000) \
        == 6 * 2048 * 64 * 1_200_000
    # about 0.94 TFLOP of InfoNCE a step at the cell's size
    assert CS.infonce_flops(2048, 64, 1_000_000, 200_000) \
        == pytest.approx(0.944e12, rel=1e-3)
    assert CS.spmm_flops(19_567_023, 64) == 2 * 19_567_023 * 64
    assert CS.spmm_keys(_counters()) == sorted(
        f"spmm.{n}_{d}" for n in ("n", "view1", "view2")
        for d in ("fwd", "t"))


def test_the_cell_sets_its_limits_and_the_configuration_its_numbers():
    conf = json.loads((REPO / "h100bench/configs/sgl_1m.json").read_text())
    lgn = json.loads((REPO / "h100bench/configs/lightgcn_1m.json")
                     .read_text())
    assert conf["reduced"] == []
    # lightgcn_1m's encoder, recipe and geometry, SGL-ED's three numbers
    for k in ("n_user", "n_item", "graph", "params"):
        assert conf[k] == lgn[k]
    assert {k: v for k, v in conf["recipe"].items()
            if not k.startswith("ssl_")} == lgn["recipe"]
    assert conf["recipe"]["ssl_reg"] == 0.5
    assert conf["recipe"]["ssl_ratio"] == 0.1
    assert conf["recipe"]["ssl_temp"] == 0.2
    assert set(LIMITS) == {"loss_gap", "grad_gap", "change_gap",
                           "triples_valid", "views_valid"}
    assert LIMITS["triples_valid"] == LIMITS["views_valid"] == 0
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (entry,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert entry["chips"] == 1 and entry["config"] == "sgl_1m"
    names = {m["name"] for m in bench["per_layer"]
             if CELL in m["workloads"]}
    assert names == {"train_mfu.sgl", "spmm_rows_roofline.sgl",
                     "spmm_share.sgl", "device_idle.sgl",
                     "view_build_s.sgl", "k1_adamw_roofline.pretrain",
                     "bpr_sample_ms.pretrain"}
