"""The tie-neutral OneHotMatrix 1 gate on the port: ``gdmcf_torch.parity_run
--dump-scores`` against the JAX package's ``benchmarks/parity_run.py
--dump-scores``.

- ``final_scores`` at weights carried across by ``gdmcf_torch.compat``
  equals the JAX loop of ``benchmarks/parity_run.py`` (its block adjacency,
  ``p_sample`` under ``PRNGKey(0)``, the [B, n_item] block, no zeroing, no
  mask), run here on the CPU, within rtol 1e-5 / atol 1e-6 (the forward's
  tolerance), at OneHotMatrix 1 and, as a check of the row range, at 0;
- the unchanged ``benchmarks/oh1_neutral_eval.py``, run as a script on two
  dumps of ``python -m gdmcf_torch.parity_run --dump-scores`` with every
  JAX module it imports taken from this checkout, prints its verdict, and
  the comparator's own ``side`` on the port's load of the splits gives the
  numbers it printed.
"""

import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch import compat  # noqa: E402
from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.parity_run import final_scores  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_USER, N_ITEM, B = 28, 20, 8

# benchmarks/oh1_neutral_eval.py run as a script (its argv after ``-c``),
# with the JAX loader imported from PYTHONPATH first; the files of every
# gdmcf_tpu module it used go to stderr's last line
JUDGE = """
import json, runpy, sys
import gdmcf_tpu.data.loader
sys.argv = ["benchmarks/oh1_neutral_eval.py"] + sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
print(json.dumps([m.__file__ for n, m in sys.modules.items()
                  if n.split(".")[0] == "gdmcf_tpu"
                  and getattr(m, "__file__", None)]), file=sys.stderr)
"""


def jax_dump(trainer, params, train_csr, n_rows):
    """benchmarks/parity_run.py's --dump-scores loop, as it is written."""
    cfg = trainer.cfg
    dense = np.asarray(train_csr.todense(), dtype=np.float32)[:n_rows]
    bs = cfg.batch_size
    key = jax.random.PRNGKey(0)
    rows = []
    for start in range(0, (n_rows // bs) * bs, bs):
        x = jnp.asarray(dense[start:start + bs])
        b = x.shape[0]
        blk = (trainer._to_block_onehot(x)
               if cfg.OneHotMatrix == 1 else x)
        s = trainer.diffusion.p_sample(
            trainer.model.apply, params, blk,
            jnp.arange(start, start + b, dtype=jnp.int32), key,
            sampling_steps=cfg.sampling_steps,
            sampling_noise=cfg.sampling_noise)
        if cfg.OneHotMatrix == 1:
            s = s[:b, b:]
        rows.append(np.asarray(s))
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("ohm", [1, 0])
def test_the_dump_matches_the_jax_loop(ohm):
    cfg = dict(backbone="DNN", OneHotMatrix=ohm, dims=[16], emb_size=10,
               steps=5, batch_size=B, sampling_steps=0, noise_scale=0.01)
    jt = JTrainer(JConfig(**cfg), N_USER, N_ITEM)
    params = jt.init_state().params
    tt = TTrainer(TConfig(device="cpu", **cfg), N_USER, N_ITEM)
    tt.model.load_state_dict({
        k: torch.from_numpy(np.array(v)) for k, v in
        compat.state_dict_from_jax_params(
            jax.tree_util.tree_map(np.asarray, params)).items()})
    rng = np.random.default_rng(4)
    train = sp.csr_matrix((rng.random((N_USER, N_ITEM)) < 0.3)
                          .astype(np.float32))
    want = jax_dump(jt, params, train, N_USER)
    got = final_scores(tt, train, N_USER)
    # 28 rows in batches of 8: the trailing 4 are not scored
    assert got.shape == want.shape == ((N_USER // B) * B, N_ITEM)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # raw: scores the eval step would zero (<= 0.1) are kept as they are
    low = got[got <= 0.1]
    assert low.size and (low != 0).any()


def test_the_comparator_ranks_two_port_dumps(tmp_path):
    from gdmcf_torch.data.loader import (data_load_dir,
                                         generate_synthetic_dataset)

    data = tmp_path / "data"
    generate_synthetic_dataset(str(data) + "/", n_user=48, n_item=120,
                               avg_degree=6, seed=5)
    stem = tmp_path / "torch"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    run = subprocess.run(
        [sys.executable, "-m", "gdmcf_torch.parity_run", "--device", "cpu",
         "--data-dir", str(data), "--backbone", "DNN", "--OneHotMatrix",
         "1", "--lr", "1e-3", "--batch", "16", "--dims", "16",
         "--epochs", "5", "--seeds", "0", "1", "--dump-scores", str(stem),
         "--out", str(tmp_path / "runs.json")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    runs = json.loads((tmp_path / "runs.json").read_text())["runs"]
    assert [r["scores_path"] for r in runs] == [f"{stem}.s0.npy",
                                                f"{stem}.s1.npy"]
    dumps = sorted(glob.glob(f"{stem}.s*.npy"))
    assert [np.load(p).shape for p in dumps] == [(48, 120)] * 2
    # the comparator's load_data puts an absolute checkout path ahead of
    # sys.path; the loader imported from this checkout first is the one its
    # import then finds in the module cache
    judge = subprocess.run(
        [sys.executable, "-c", JUDGE, "--data-dir", str(data), "--ref",
         f"{stem}.s0.npy", "--ours", f"{stem}.s1.npy"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert judge.returncode == 0, judge.stderr[-3000:]
    imported = json.loads(judge.stderr.strip().splitlines()[-1])
    assert imported and all(Path(f).resolve().is_relative_to(ROOT)
                            for f in imported), imported
    verdict = json.loads(judge.stdout)
    assert "parity" in verdict and set(verdict["checks"]) == {
        "test_recall@20", "test_ndcg@20"}
    # the same ranking from the comparator's own side() on the port's load
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        from oh1_neutral_eval import side
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))
    splits = data_load_dir(str(data))[:3]
    tr, va, te = (m.astype(np.float32).toarray() for m in splits)
    rows = side(dumps, tr, va, te)
    assert [r["test"][20] for r in rows] == [
        r["test"]["20"] for r in verdict["reference"] + verdict["gdmcf_tpu"]]
