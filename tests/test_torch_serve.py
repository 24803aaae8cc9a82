"""The slice as a whole: a JAX Recommender on the lightGCN backbone, its
params carried across with the weight bridge, against the port's
Recommender on the CPU (plain SpMM versions, hybrid operand forced).

Top-k ids must be identical; the masked scores before top-k agree to
rtol 1e-4 / atol 1e-5 (float32 products of a few hundred terms summed in
another order, through tanh layers).
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch import compat  # noqa: E402
from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.models import lightgcn as TG  # noqa: E402
from gdmcf_torch.ops import spmm as TS  # noqa: E402
from gdmcf_torch.serve import Recommender as TRecommender  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.ops.bitpack import unpack_rows  # noqa: E402
from gdmcf_tpu.serve import Recommender as JRecommender  # noqa: E402
from gdmcf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402

N_USER, N_ITEM = 40, 90
RECIPE = dict(backbone="lightGCN", dims=[24], emb_size=10, steps=5,
              noise_scale=1e-4, mean_type="x0", sampling_steps=0,
              OneHotMatrix=2, wire_format="packed", random_seed=3)


def interactions(seed=0):
    rng = np.random.default_rng(seed)
    p = (np.arange(N_ITEM) + 1.0) ** -0.6
    rows, cols = [], []
    for u in range(N_USER):
        items = rng.choice(N_ITEM, size=rng.integers(2, 15), replace=False,
                           p=p / p.sum())
        rows += [u] * len(items)
        cols += list(items)
    return sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                         shape=(N_USER, N_ITEM))


@pytest.fixture(scope="module")
def pair():
    """(JAX recommender, port recommender) sharing the JAX params."""
    train = interactions()
    jt = JTrainer(JConfig(**RECIPE), N_USER, N_ITEM, train_csr=train)
    jrec = JRecommender.from_state(jt, jt.init_state(), train,
                                   serve_batch=8, k_max=12)
    params = jax.tree_util.tree_map(np.asarray, jrec.params)
    mp = pytest.MonkeyPatch()
    mp.setattr(TG, "_DENSE_LIMIT_BYTES", 0)   # force the hybrid operand
    try:
        tt = TTrainer(TConfig(device="cpu", **RECIPE), N_USER, N_ITEM,
                      train_csr=train)
    finally:
        mp.undo()
    state = compat.state_dict_from_jax_params(params)
    trec = TRecommender.from_state(tt, state, train, serve_batch=8,
                                   k_max=12)
    return jrec, trec, params, train


def test_bridge_names_and_roundtrip(pair):
    _, trec, params, _ = pair
    sd = trec.trainer.model.state_dict()
    assert set(sd) == set(compat.state_dict_from_jax_params(params))
    back = compat.jax_params_from_state_dict(sd)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        got = back
        for p in path:
            got = got[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_array_equal(got, leaf)
    w_jax = params["in_layers"][0]["w"]
    assert sd["in_layers.0.weight"].shape == w_jax.shape[::-1]


def test_port_used_the_hybrid_operand():
    """The fixture's port model was built with the hybrid operand: its own
    propagation (before the bridge overwrote the tables) ran on the
    hybrid's row operands, which hold every nonzero of N."""
    train = interactions()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TG, "_DENSE_LIMIT_BYTES", 0)
        calls = []
        real = TG.spmm_op
        mp.setattr(TG, "spmm_op", lambda op, op_opposite, x:
                   calls.append(op) or real(op, op_opposite, x))
        TTrainer(TConfig(device="cpu", **RECIPE), N_USER, N_ITEM,
                 train_csr=train)
    # 2 layers x 2 directions
    assert [op.transpose for op in calls] == [False, True] * 2
    assert all(op.nnz == train.nnz for op in calls)


@pytest.mark.parametrize("exclude", [True, False])
def test_recommend_matches_jax(pair, exclude):
    jrec, trec, _, train = pair
    users = [0, 3, 7, 11, 19, 23, 31, 39, 5, 2, 17]   # two dispatches
    j_items, _ = jrec.recommend(users, k=10, exclude_history=exclude)
    t_items, t_users = trec.recommend(users, k=10, exclude_history=exclude)
    np.testing.assert_array_equal(t_users, users)
    np.testing.assert_array_equal(t_items, j_items)
    if exclude:
        hist = train.toarray() > 0
        for u, row in zip(users, t_items):
            assert not hist[u, row].any()


def test_scores_before_topk_match_jax(pair):
    jrec, trec, params, train = pair
    users = np.array([1, 4, 9, 16, 25, 36, 38, 0], np.int64)
    rows = trec.history.gather_packed(users)
    mask = rows.copy()
    mask[5:] = 0   # mixed per-row exclusion
    jt = jrec.trainer
    x = jnp.asarray(train[users].toarray(), jnp.float32)
    scores_j = jt.diffusion.p_sample(jt.model.apply, jrec.params, x,
                                     jnp.asarray(users, jnp.int32),
                                     jax.random.PRNGKey(0), 0)
    mask_j = np.asarray(unpack_rows(jnp.asarray(mask), N_ITEM))
    scores_j = np.where(mask_j > 0, -np.inf, np.asarray(scores_j))
    idx, scores_t = trec.trainer.eval_step(
        torch.from_numpy(rows), torch.from_numpy(users),
        torch.from_numpy(mask), sampling_steps=0, top_k=12,
        return_scores=True)
    np.testing.assert_array_equal(np.isinf(scores_t.numpy()),
                                  np.isinf(scores_j))
    np.testing.assert_allclose(scores_t.numpy(), scores_j, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.argsort(-scores_j, kind="stable",
                                             axis=1)[:, :12])


def test_port_serving_is_deterministic(pair):
    """At sampling_steps 0 this backbone ignores the grown graph, so the
    same users get the same ids every time."""
    _, trec, _, _ = pair
    users = [2, 8, 14, 20, 26, 32, 38, 1, 7]
    first, _ = trec.recommend(users, k=12)
    again, _ = trec.recommend(users, k=12)
    np.testing.assert_array_equal(first, again)
    assert ((first >= 0) & (first < N_ITEM)).all()
    assert all(len(set(r)) == len(r) for r in first.tolist())


def test_recommend_validates_requests(pair):
    _, trec, _, _ = pair
    with pytest.raises(ValueError, match="k="):
        trec.recommend([0], k=13)
    with pytest.raises(ValueError, match="user ids"):
        trec.recommend([N_USER], k=5)
    with pytest.raises(ValueError, match="at least one"):
        trec.recommend([], k=5)
    with pytest.raises(ValueError, match="recommend_batch"):
        trec.recommend_batch(np.arange(9), np.ones(9, bool))


def test_no_cuda_kernel_ran_on_the_cpu_path(pair):
    """CPU tensors take the plain versions: no kernel launch is counted."""
    _, trec, _, _ = pair
    TS.reset_launch_counts()
    trec.recommend([0, 1], k=5)
    assert TS.LAUNCHES == {"spmm_rows_fwd": 0, "spmm_rows_t": 0}
