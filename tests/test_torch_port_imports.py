"""The port imports neither JAX nor gdmcf_tpu, and its entry points refuse to
fall back to the CPU silently."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
        ".__init__", "")
    for p in (ROOT / "gdmcf_torch").rglob("*.py"))


def test_port_imports_no_jax_and_no_reference_package():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'triton')"
            " or m.startswith(('jax.', 'triton.', 'gdmcf_tpu', 'optax', "
            "'orbax')))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(MODULES) >= 15 and "gdmcf_torch.pretrain_cli" in MODULES


def test_the_parallel_modules_are_among_those_checked():
    """``gdmcf_torch.parallel.*`` is imported by the check above (the
    module list is every file of the package), so the mesh layer imports
    neither JAX nor the JAX package either."""
    parallel = {m for m in MODULES if m.startswith("gdmcf_torch.parallel")}
    assert parallel == {f"gdmcf_torch.parallel{s}" for s in (
        "", ".channel", ".collectives", ".embed", ".layers", ".mesh",
        ".multihost", ".rows", ".sharding")}


def test_pretraining_names_import_without_jax():
    code = ("import sys\n"
            "from gdmcf_torch.models.lightgcn import (bpr_loss, bpr_step, "
            "pretrain, propagator, initial_table, sample_bpr_batch, "
            "save_embeddings, LightGCNResult)\n"
            "from gdmcf_torch.ops.spmm import spmm_op\n"
            "from gdmcf_torch.ops.metrics import lightgcn_topn_metrics\n"
            "from gdmcf_torch.data.loader import generate_ml100k_csv, "
            "load_ml100k\n"
            "from gdmcf_torch.data.native import NativeCSR\n"
            "from gdmcf_torch.pretrain_cli import main\n"
            "assert callable(NativeCSR.sample_bpr)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'gdmcf_tpu', 'pandas', 'sklearn')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", ["gdmcf_torch", "chip_smoke.py"])
def test_port_sources_name_no_reference_package(path):
    """No import of JAX, of the JAX package or of its optimizer library,
    and no use of that library's names. The word itself may appear: it is
    a value of ``opt_impl``, which the port accepts (and runs as its
    single-pass AdamW)."""
    files = ([ROOT / path] if path.endswith(".py")
             else list((ROOT / path).rglob("*.py"))
             + list((ROOT / path).rglob("*.cu")))
    for f in files:
        text = f.read_text()
        for word in ("import jax", "from jax", "gdmcf_tpu", "import optax",
                     "from optax", "optax."):
            assert word not in text, f"{f} mentions {word!r}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_refuses_silent_cpu(monkeypatch):
    from gdmcf_torch import resolve_device

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_entry_points_raise_without_cuda(monkeypatch):
    import scipy.sparse as sp

    from gdmcf_torch.config import Config
    from gdmcf_torch.serve import build_recommender
    from gdmcf_torch.train.trainer import Trainer

    _no_cuda(monkeypatch)
    csr = sp.csr_matrix(([1.0, 1.0], ([0, 1], [1, 2])), shape=(3, 4))
    cfg = Config(backbone="lightGCN", dims=[8], steps=5, noise_scale=1e-4,
                 sampling_steps=0)
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, 3, 4, train_csr=csr)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_recommender(cfg, None, csr, 3, 4)
    from gdmcf_torch.models.lightgcn import pretrain
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain(csr, csr, epochs=1, latent_dim=4)
    # an explicit CPU request runs
    rec = build_recommender(cfg, None, csr, 3, 4, device="cpu",
                            serve_batch=4, k_max=2)
    assert rec.recommend([0, 2], k=2)[0].shape == (2, 2)


def test_serve_cli_device_flag_and_checkpoint_refusal(tmp_path, capsys):
    import numpy as np

    from gdmcf_torch.serve import main

    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, 12, 60), rng.integers(0, 9, 60)], 1)
    edges[0] = [11, 8]
    for name in ("train", "valid", "test"):
        np.save(tmp_path / f"{name}_list.npy", edges)
    base = ["--backbone", "lightGCN", "--dims", "[8]", "--steps", "5",
            "--noise_scale", "1e-4", "--sampling_steps", "0",
            "--data_path", str(tmp_path), "--users", "0,3,5", "--k", "4",
            "--serve_batch", "2", "--k_max", "5"]
    main(base + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "user 5: top-4" in out and "on cpu" in out
    # an explicit checkpoint directory must hold a checkpoint and exist
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        main(base + ["--device", "cpu", "--ckpt_dir_serve", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="does not exist"):
        main(base + ["--device", "cpu", "--ckpt_dir_serve",
                     str(tmp_path / "missing")])


def test_other_backbones_name_their_roadmap_item():
    """Every backbone name builds; an unknown one raises; the legacy and
    ablation diffusion variants and the noise_scale=0 reverse path, once
    refused naming their ROADMAP.md item, now build and run."""
    from gdmcf_torch.config import Config
    from gdmcf_torch.diffusion.engine import Diffusion
    from gdmcf_torch.models.registry import BACKBONES, build_model

    g = torch.Generator().manual_seed(0)
    for b in BACKBONES:
        m = build_model(Config(backbone=b, dims=[8]), 4, 6, generator=g,
                        device="cpu")
        assert isinstance(m, torch.nn.Module)
    with pytest.raises(ValueError):
        build_model(Config(backbone="nope"), 4, 5, generator=g, device="cpu")
    for variant in ("legacy", "ablation"):
        assert Diffusion.create(Config(), variant=variant).variant == variant
    flat = Diffusion.create(Config(noise_scale=0.0, steps=5))
    out = flat.p_sample(lambda x, t, x_U, index, graph: (x + 1.0, None),
                        torch.zeros(2, 3), torch.zeros(2).long(),
                        sampling_steps=0)
    assert torch.equal(out, torch.full((2, 3), 5.0))


def _modules_after(code: str):
    """sys.modules' names after running ``code`` in a fresh interpreter
    with the repo on its path."""
    code += "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))\n"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import json
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_serve_front_imports_no_torch():
    """A pre-forked front stays light: importing its module (and through it
    the package) loads neither torch nor JAX nor the JAX package."""
    mods = _modules_after("import gdmcf_torch.serve_front\n"
                          "from gdmcf_torch.serve_front import (Backend, "
                          "BackendUnreachable, ReusePortHTTPServer, "
                          "front_serve, make_handler, spawn_fronts, main)")
    bad = [m for m in mods if m in ("torch", "jax", "triton")
           or m.startswith(("torch.", "jax.", "gdmcf_tpu"))]
    assert not bad, bad
    assert "gdmcf_torch.serve_front" in mods and "numpy" in mods


def test_serving_and_compat_names_import_without_jax():
    mods = _modules_after(
        "from gdmcf_torch.serve_http import (Coalescer, make_server, "
        "serve_multiproc, supervise_fronts, main)\n"
        "from gdmcf_torch.serve import Recommender\n"
        "assert callable(Recommender.reload_params)\n"
        "from gdmcf_torch.compat import (params_from_state_dict, "
        "import_reference_embeddings, import_reference_checkpoint, main)\n"
        "from gdmcf_torch.diffusion.engine import (mix_tensors, normal_kl, "
        "absorbing_qt_bar, LegacyNoiseDraws)")
    bad = [m for m in mods if m == "jax" or m.startswith(("jax.",
                                                          "gdmcf_tpu"))]
    assert not bad, bad


def test_the_host_utility_and_parity_modules_are_among_those_checked():
    """The prefetch thread, the profiling hooks, the graph converters and
    the parity runner are modules of the package, so the check above
    imports them too; importing them loads neither JAX nor Triton."""
    for m in ("gdmcf_torch.data.prefetch", "gdmcf_torch.utils.profiling",
              "gdmcf_torch.data.graph_convert", "gdmcf_torch.parity_run"):
        assert m in MODULES, m
    mods = _modules_after(
        "from gdmcf_torch.data.prefetch import prefetched\n"
        "from gdmcf_torch.utils.profiling import (span, span_totals, "
        "trace)\n"
        "from gdmcf_torch.data.graph_convert import (adjacency_to_edge, "
        "topk_set)\n"
        "from gdmcf_torch.data.native import NativeCSR\n"
        "assert callable(NativeCSR.from_edge_list)\n"
        "from gdmcf_torch.ops.fused_adamw import (adamw_master_update_, "
        "adamw_master_reference, master_update_bounds)\n"
        "from gdmcf_torch.parity_run import main")
    bad = [m for m in mods if m in ("jax", "triton")
           or m.startswith(("jax.", "triton.", "gdmcf_tpu", "optax"))]
    assert not bad, bad


def test_the_graph_module_is_among_those_checked():
    """``train/graphs.py`` (the CUDA graphs of the fused calls) is a module
    of the package, so the check above imports it; importing it loads
    neither JAX nor Triton and touches no CUDA device."""
    assert "gdmcf_torch.train.graphs" in MODULES
    mods = _modules_after(
        "from gdmcf_torch.train.graphs import (TrainerGraphs, TrainGraph, "
        "EvalGraph)\n"
        "from gdmcf_torch.ops.fused_adamw import add_replays, CAPTURED\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()")
    bad = [m for m in mods if m in ("jax", "triton") or m.startswith(
        ("jax.", "triton.", "gdmcf_tpu"))]
    assert not bad, bad
