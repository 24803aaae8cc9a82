"""Block-sparse SpMM in the port against the JAX package: host builders,
plain forward/transpose products and the hybrid format. The row operand the
CUDA kernel walks is in ``test_torch_spmm_rows.py``, the kernel against its
plain version in ``test_torch_kernels_gpu.py``.

Inputs are made from a seed with numpy and fed to both. Products are held
to rtol 1e-5 / atol 1e-6 against the JAX oracle and against a float64
dense product: both sum float32 terms in a different order, which moves
the result by a few float32 ulps of the row sum.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gdmcf_torch.ops import spmm as T  # noqa: E402
from gdmcf_tpu.ops import spmm as J  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def matrix(seed, n_rows, n_cols, density, br, bc, n_dup=16):
    """COO with an empty row tile, an empty column tile and duplicates."""
    m = sp.random(n_rows, n_cols, density=density,
                  random_state=np.random.RandomState(seed), format="coo",
                  dtype=np.float32)
    keep = ~(((m.row >= br) & (m.row < 2 * br))
             | ((m.col >= bc) & (m.col < 2 * bc)))
    r, c, v = m.row[keep], m.col[keep], m.data[keep]
    dup = np.random.default_rng(seed).integers(0, len(r), n_dup)
    return sp.coo_matrix((np.concatenate([v, v[dup]]),
                          (np.concatenate([r, r[dup]]),
                           np.concatenate([c, c[dup]]))),
                         shape=(n_rows, n_cols))


def flat(a, name, n):
    return np.asarray(getattr(a, name)).reshape(-1)[:n]


def assert_same_format(ja, ta):
    # an empty matrix stores one zero tile (and zero metadata) in both
    assert ta.n_blocks == int(ja.row_ptr[-1])
    nb = max(ta.n_blocks, 1)
    assert ta.shape == ja.shape and (ta.br, ta.bc) == (ja.br, ja.bc)
    assert (ta.max_row_width, ta.max_col_width) == (ja.max_row_width,
                                                   ja.max_col_width)
    np.testing.assert_array_equal(ta.blocks[:nb].numpy(),
                                  np.asarray(ja.blocks)[:nb])
    for name in ("row_ptr", "col_ptr"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)))
    for name in ("block_cols", "block_ids", "block_rows", "block_rows_csr"):
        np.testing.assert_array_equal(getattr(ta, name)[:nb].numpy(),
                                      flat(ja, name, nb))


SHAPES = [  # (n_rows, n_cols, density, br, bc)
    (300, 260, 0.03, 128, 128),
    (90, 300, 0.05, 8, 128),
    (70, 50, 0.1, 8, 16),
    (50, 70, 0.1, 16, 8),
]


@pytest.mark.parametrize("n_rows,n_cols,density,br,bc", SHAPES)
def test_to_block_sparse_matches_jax(n_rows, n_cols, density, br, bc):
    m = matrix(1, n_rows, n_cols, density, br, bc)
    assert_same_format(J.to_block_sparse(m, br, bc),
                       T.to_block_sparse(m, br, bc))


def test_to_hybrid_and_degree_sort_match_jax():
    m = matrix(2, 120, 200, 0.04, 8, 128)
    jh, th = J.to_hybrid(m, br=8, bc=128), T.to_hybrid(m, br=8, bc=128)
    assert_same_format(jh.tiles, th.tiles)
    for name in ("rem_rows", "rem_cols", "rem_vals"):
        np.testing.assert_array_equal(getattr(th, name).numpy(),
                                      np.asarray(getattr(jh, name)))
    for jp, tp in zip(J.degree_sort_permutation(m),
                      T.degree_sort_permutation(m)):
        np.testing.assert_array_equal(jp, tp)


def test_empty_matrix_format():
    m = sp.coo_matrix((20, 30), dtype=np.float32)
    ja, ta = J.to_block_sparse(m, 8, 16), T.to_block_sparse(m, 8, 16)
    assert_same_format(ja, ta)
    y = T.spmm(ta, torch.ones(30, 4))
    assert y.shape == (24, 4) and not y.any()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n_rows,n_cols,density,br,bc,d", [
    (300, 260, 0.03, 128, 128, 64),
    (90, 300, 0.05, 8, 128, 50),
    (70, 50, 0.1, 8, 16, 130),
    (50, 70, 0.1, 16, 8, 24),
])
def test_plain_spmm_matches_jax_reference_and_dense(n_rows, n_cols, density,
                                                    br, bc, d, transpose):
    m = matrix(3, n_rows, n_cols, density, br, bc)
    rng = np.random.default_rng(4)
    n_x = n_rows if transpose else n_cols
    x = rng.standard_normal((n_x, d)).astype(np.float32)
    ta = T.to_block_sparse(m, br, bc)
    y = T.spmm(ta, torch.from_numpy(x), transpose).numpy()
    n_out = n_cols if transpose else n_rows
    assert y.shape == ((ta.shape[1] if transpose else ta.shape[0]), d)
    y_jax = np.asarray(J.spmm_reference(J.to_block_sparse(m, br, bc),
                                        jnp.asarray(x), transpose))
    np.testing.assert_allclose(y, y_jax, **TOL)
    dense = m.toarray().astype(np.float64)
    want = (dense.T if transpose else dense) @ x.astype(np.float64)
    np.testing.assert_allclose(y[:n_out], want, **TOL)
    assert not y[n_out:].any(), "pad rows must be zero"
    empty = slice(bc, 2 * bc) if transpose else slice(br, 2 * br)
    assert not y[empty].any(), "an empty tile must give zeros"


def test_spmm_accepts_short_and_long_x():
    """x may hold fewer rows than the tile grid (missing rows read as zero)
    or more (dropped), as in the JAX package."""
    m = matrix(5, 40, 50, 0.2, 8, 16)
    ta = T.to_block_sparse(m, 8, 16)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (64, 8)).astype(np.float32))
    full = T.spmm(ta, x[:50])
    torch.testing.assert_close(T.spmm(ta, x), full)
    short = T.spmm(ta, x[:45])
    want = torch.from_numpy(m.toarray()[:, :45]).float() @ x[:45]
    torch.testing.assert_close(short[:40], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("transpose", [False, True])
def test_hybrid_spmm_matches_jax_and_dense(transpose):
    m = matrix(7, 120, 96, 0.03, 8, 16)
    x = np.random.default_rng(8).standard_normal(
        (120 if transpose else 96, 20)).astype(np.float32)
    th = T.to_hybrid(m, br=8, bc=16, min_fill=4)
    assert th.rem_vals.numel() > 0 and th.tiles.n_blocks > 0
    y = T.hybrid_spmm(th, torch.from_numpy(x), transpose).numpy()
    jh = J.to_hybrid(m, br=8, bc=16, min_fill=4)
    y_jax = np.asarray(J.hybrid_spmm(J.hybrid_meta(jh), J.hybrid_arrays(jh),
                                     jnp.asarray(x), transpose,
                                     interpret=True))
    np.testing.assert_allclose(y, y_jax, **TOL)
    dense = m.toarray().astype(np.float64)
    want = (dense.T if transpose else dense) @ x.astype(np.float64)
    np.testing.assert_allclose(y[:want.shape[0]], want, **TOL)
    torch.testing.assert_close(
        T.hybrid_spmm_reference(th, torch.from_numpy(x), transpose),
        torch.from_numpy(y))


def test_max_bytes_refusal():
    m = matrix(9, 256, 256, 0.05, 128, 128)
    with pytest.raises(ValueError, match="densification"):
        T.to_block_sparse(m, 128, 128, max_bytes=1 << 15)
    with pytest.raises(ValueError, match="densification"):
        T.to_hybrid(m, br=8, bc=128, min_fill=1, max_bytes=1 << 10)


@pytest.mark.parametrize("transpose", [False, True])
def test_plain_spmm_matches_jax_pallas_interpret(transpose):
    m = matrix(10, 40, 136, 0.08, 8, 128)
    x = np.random.default_rng(11).standard_normal(
        (40 if transpose else 136, 16)).astype(np.float32)
    y = T.spmm(T.to_block_sparse(m, 8, 128), torch.from_numpy(x),
               transpose).numpy()
    y_pallas = np.asarray(J.spmm(J.to_block_sparse(m, 8, 128),
                                 jnp.asarray(x), transpose, interpret=True))
    np.testing.assert_allclose(y, y_pallas, **TOL)
