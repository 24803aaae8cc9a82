"""The port's host-side copies (config, edge-list loader, structure-only
CSR, bit-packing) and its exact top-k, against the JAX package."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gdmcf_torch import config as TC  # noqa: E402
from gdmcf_torch.data import loader as TL  # noqa: E402
from gdmcf_torch.data.native import NativeCSR as TNative  # noqa: E402
from gdmcf_torch.ops import bitpack as TB  # noqa: E402
from gdmcf_torch.ops.topk import chunked_topk  # noqa: E402
from gdmcf_tpu import config as JC  # noqa: E402
from gdmcf_tpu.data import loader as JL  # noqa: E402
from gdmcf_tpu.data.native import NativeCSR as JNative  # noqa: E402
from gdmcf_tpu.ops import bitpack as JB  # noqa: E402
from gdmcf_tpu.ops.topk import chunked_topk as j_chunked_topk  # noqa: E402

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs")
                 .glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_recipes_load_like_jax(path):
    t = TC.load_config(str(path), {"device": "cpu"})
    j = JC.load_config(str(path))
    for f in dataclasses.fields(TC.Config):
        if hasattr(j, f.name):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.out_dims(500) == j.out_dims(500)
    assert t.in_dims(500) == j.in_dims(500)


def test_parse_args_flags_and_device():
    cfg = TC.parse_args(["-c", str(CONFIGS[0]), "--backbone", "lightGCN",
                         "--dims", "[64]", "--topN", "10,20",
                         "--device", "cpu", "--norm"])
    assert cfg.backbone == "lightGCN" and cfg.dims == [64]
    assert cfg.topN == [10, 20] and cfg.norm is True
    assert cfg.device == "cpu"
    assert TC.parse_args([]).device == "cuda"
    with pytest.raises(ValueError, match="device"):
        TC.Config(device="tpu")
    with pytest.raises(KeyError):
        TC.load_config(None, {"no_such_flag": 1})


def test_data_load_dir_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    edges = {n: np.stack([rng.integers(0, 30, 90), rng.integers(0, 20, 90)],
                         1) for n in ("train", "valid", "test")}
    edges["train"][0] = [29, 19]
    for name, e in edges.items():
        np.save(tmp_path / f"{name}_list.npy", e)
    got, want = TL.data_load_dir(str(tmp_path)), JL.data_load_dir(
        str(tmp_path))
    assert got[3:] == want[3:] == (30, 20)
    for g, w in zip(got[:3], want[:3]):
        assert (g != w).nnz == 0
    np.save(tmp_path / "valid_list.npy", np.array([[30, 0]]))
    with pytest.raises(ValueError, match="outside"):
        TL.data_load_dir(str(tmp_path))


def test_native_csr_gathers_match_jax():
    rng = np.random.default_rng(1)
    m = sp.random(25, 37, density=0.2, random_state=np.random.RandomState(1),
                  format="csr")
    m.data[:] = 1.0
    rows = rng.integers(0, 25, 11)
    t, j = TNative.from_scipy(m), JNative.from_scipy(m)
    np.testing.assert_array_equal(t.gather(rows), j.gather(rows))
    np.testing.assert_array_equal(t.gather_packed(rows),
                                  j.gather_packed(rows))
    m.data[:3] = 2.0
    with pytest.raises(ValueError, match="structure-only"):
        TNative.from_scipy(m)
    loose = TNative.from_scipy(m, strict=False)
    np.testing.assert_array_equal(loose.gather(rows), j.gather(rows))
    assert len(loose) == 25


@pytest.mark.parametrize("n", [1, 8, 37])
def test_bitpack_matches_jax(n):
    x = (np.random.default_rng(n).random((3, 4, n)) < 0.4).astype(np.float32)
    packed = TB.pack_rows(x)
    np.testing.assert_array_equal(packed, JB.pack_rows(x))
    got = TB.unpack_rows(torch.from_numpy(packed), n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JB.unpack_rows(jnp.asarray(packed), n)))
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("b,n,k,chunk", [
    (4, 50, 7, 512),       # small: one stable select
    (5, 1300, 20, 128),    # chunked, with a ragged last chunk
    (3, 1024, 100, 128),   # k close to the chunk size
])
def test_chunked_topk_is_exact_with_lowest_index_ties(b, n, k, chunk):
    rng = np.random.default_rng(n)
    scores = rng.integers(0, 6, (b, n)).astype(np.float32)   # many ties
    scores[0, : n // 2] = -np.inf
    scores[-1] = -np.inf                                     # all masked
    vals, idx = chunked_topk(torch.from_numpy(scores), k, chunk=chunk)
    j_vals, j_idx = j_chunked_topk(jnp.asarray(scores), k, chunk=chunk)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    want = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx.numpy()[:-1], want[:-1])
    assert (idx.numpy() < n).all()
