"""The row operand that the SpMM kernel walks, and its plain product, against
scipy and the JAX package.

The operand is checked entry by entry against scipy's CSR of A and of A^T
(duplicates summed, empty rows present, values bitwise those the tiles
hold), its segments against their definition, and the plain row product
against the JAX package's reference, its Pallas kernels in interpret mode
and its hybrid product, at rtol 1e-5 / atol 1e-6: both sum the same float32
terms in another order. Inputs are made from a seed with numpy.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gdmcf_torch.models import lightgcn as TG  # noqa: E402
from gdmcf_torch.ops import spmm as T  # noqa: E402
from gdmcf_tpu.models import lightgcn as JG  # noqa: E402
from gdmcf_tpu.ops import spmm as J  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)

SHAPES = [  # (n_rows, n_cols, density, br, bc), as in test_torch_spmm.py
    (300, 260, 0.03, 128, 128),
    (90, 300, 0.05, 8, 128),
    (70, 50, 0.1, 8, 16),
    (50, 70, 0.1, 16, 8),
]


def matrix(seed, n_rows, n_cols, density, br, bc, n_dup=16):
    """COO with an empty row tile, an empty column tile, duplicates and a
    dense row and column (row 0, column 0) that miss the empty tiles."""
    m = sp.random(n_rows, n_cols, density=density,
                  random_state=np.random.RandomState(seed), format="coo",
                  dtype=np.float32)
    keep = ~(((m.row >= br) & (m.row < 2 * br))
             | ((m.col >= bc) & (m.col < 2 * bc)))
    r, c, v = m.row[keep], m.col[keep], m.data[keep]
    dup = np.random.default_rng(seed).integers(0, len(r), n_dup)
    dr = np.setdiff1d(np.arange(n_rows), np.arange(br, 2 * br))
    dc = np.setdiff1d(np.arange(n_cols), np.arange(bc, 2 * bc))
    one = np.full(len(dr) + len(dc), 0.25, np.float32)
    return sp.coo_matrix(
        (np.concatenate([v, v[dup], one]),
         (np.concatenate([r, r[dup], dr, np.zeros(len(dc), np.int64)]),
          np.concatenate([c, c[dup], np.zeros(len(dr), np.int64), dc]))),
        shape=(n_rows, n_cols))


def padded_csr(m, shape):
    coo = m.tocoo()
    return sp.csr_matrix((coo.data.astype(np.float32), (coo.row, coo.col)),
                         shape=shape)


def assert_operand_is_csr(op, want, transpose):
    """``op`` holds exactly scipy's summed CSR ``want`` (explicit zeros
    dropped), every row present."""
    want = want.tocsr()
    want.sum_duplicates()
    want.eliminate_zeros()
    want.sort_indices()
    assert op.transpose == transpose and op.n_out == want.shape[0]
    np.testing.assert_array_equal(op.row_ptr.numpy(), want.indptr)
    np.testing.assert_array_equal(op.cols.numpy(), want.indices)
    np.testing.assert_allclose(op.vals.numpy(), want.data, rtol=1e-6, atol=0)
    for name in T.RowOperand._TENSORS:
        t = getattr(op, name)
        assert t.is_contiguous() and t.dtype == (
            torch.float32 if name == "vals" else torch.int32)


def entries(op):
    """(output rows, x rows, values) of an operand's nonzeros, numpy."""
    rows = np.repeat(np.arange(op.n_out), np.diff(op.row_ptr.numpy()))
    return rows, op.cols.numpy(), op.vals.numpy()


def tile_values(a, rows, cols):
    k = a.block_cols.numpy()
    tile = {(int(rb), int(cb)): i for i, (rb, cb) in enumerate(
        zip(a.block_rows_csr.numpy()[:a.n_blocks], k[:a.n_blocks]))}
    idx = np.array([tile[(r // a.br, c // a.bc)] for r, c in zip(rows, cols)],
                   np.int64)
    return a.blocks.numpy()[idx, rows % a.br, cols % a.bc]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n_rows,n_cols,density,br,bc", SHAPES)
def test_block_sparse_row_operand_matches_scipy(n_rows, n_cols, density, br,
                                                bc, transpose):
    m = matrix(1, n_rows, n_cols, density, br, bc)
    a = T.to_block_sparse(m, br, bc)
    want = padded_csr(m, a.shape)
    op = a.t_rows if transpose else a.fwd_rows
    assert_operand_is_csr(op, want.T if transpose else want, transpose)
    # the values are bitwise those the tiles hold
    out, inn, vals = entries(op)
    rows, cols = (inn, out) if transpose else (out, inn)
    np.testing.assert_array_equal(vals, tile_values(a, rows, cols))
    # every row is present, the empty tile's rows with no nonzero
    empty = slice(bc, 2 * bc) if transpose else slice(br, 2 * br)
    assert not np.diff(op.row_ptr.numpy())[empty].any()


@pytest.mark.parametrize("transpose", [False, True])
def test_hybrid_row_operand_holds_tiles_and_remainder(transpose):
    m = matrix(2, 120, 200, 0.04, 8, 16)
    h = T.to_hybrid(m, br=8, bc=16, min_fill=4)
    assert h.rem_vals.numel() > 0 and h.tiles.n_blocks > 0
    want = padded_csr(m, h.tiles.shape)
    op = h.t_rows if transpose else h.fwd_rows
    assert_operand_is_csr(op, want.T if transpose else want, transpose)
    # the tiles' entries keep the tiles' values
    tiles = h.tiles.t_rows if transpose else h.tiles.fwd_rows
    t_out, t_in, t_vals = entries(tiles)
    out, inn, vals = entries(op)
    at = dict(zip(zip(out.tolist(), inn.tolist()), vals.tolist()))
    assert [at[k] for k in zip(t_out.tolist(), t_in.tolist())] == \
        t_vals.tolist()


@pytest.mark.parametrize("seg_len", [1, 3, 64, 1000])
def test_row_segments_cover_each_row_once_in_order(seg_len):
    row_ptr = np.array([0, 0, 5, 6, 6, 140, 1140], np.int32)
    order, seg_ptr, seg_row, seg_part, row_part_ptr = T.row_segments(
        row_ptr, seg_len)
    np.testing.assert_array_equal(order, np.arange(row_ptr[-1]))
    assert len(row_part_ptr) == len(row_ptr)
    assert len(seg_ptr) == len(seg_row) + 1
    slots = []
    for r in range(len(row_ptr) - 1):
        segs = np.flatnonzero(seg_row == r)
        assert len(segs) >= 1
        np.testing.assert_array_equal(segs, np.arange(segs[0], segs[-1] + 1))
        covered = [k for s in segs for k in range(seg_ptr[s], seg_ptr[s + 1])]
        assert covered == list(range(row_ptr[r], row_ptr[r + 1]))
        assert all(seg_ptr[s + 1] - seg_ptr[s] <= seg_len for s in segs)
        if len(segs) == 1:
            assert seg_part[segs[0]] == -1
            assert row_part_ptr[r + 1] == row_part_ptr[r]
        else:
            assert list(seg_part[segs]) == list(range(row_part_ptr[r],
                                                      row_part_ptr[r + 1]))
            slots += [seg_part[s] for s in segs]
    assert slots == list(range(len(slots)))   # consecutive, from 0


N_X = 1200   # x rows of slab_csr


def slab_csr(seed=13):
    """A CSR over N_X x rows: short random rows, an empty row (3), a row
    over every x row (7), and rows of 200 nonzeros in x rows 400-599 (11)
    and 300 in 0-599 (19)."""
    m = sp.random(50, N_X, density=0.02, format="lil", dtype=np.float32,
                  random_state=np.random.RandomState(seed))
    m[3, :] = 0
    m[7, :] = 0.5
    m[11, 400:600] = 0.25
    m[19, :600] = 0.125
    csr = m.tocsr()
    csr.sort_indices()
    return csr


SLAB_CASES = [  # (seg_len, slab_rows): slabs of 7 rows to one of 1200
    (T.ROW_SEGMENT, 7), (T.ROW_SEGMENT, 150), (T.ROW_SEGMENT, 300),
    (T.ROW_SEGMENT, N_X), (5, 7), (5, 300), (1, 64)]


@pytest.mark.parametrize("seg_len,slab_rows", SLAB_CASES)
def test_slab_schedule_covers_every_nonzero_once_slab_major(seg_len,
                                                            slab_rows):
    csr = slab_csr()
    order, seg_ptr, seg_row, seg_part, row_part_ptr = T.row_segments(
        csr.indptr, seg_len, csr.indices, slab_rows)
    nnz, n_out = csr.nnz, csr.shape[0]
    np.testing.assert_array_equal(np.sort(order), np.arange(nnz))
    assert seg_ptr[0] == 0 and seg_ptr[-1] == nnz
    width = np.diff(seg_ptr)
    assert (width >= 0).all() and (width <= seg_len).all()
    rows = np.repeat(np.arange(n_out), np.diff(csr.indptr))[order]
    cols = csr.indices[order]
    seg_of = np.repeat(np.arange(len(seg_row)), width)
    np.testing.assert_array_equal(rows, seg_row[seg_of])
    cut = np.diff(csr.indptr) > seg_len
    assert set(seg_row.tolist()) == set(range(n_out))   # every row, once+
    # a row's nonzeros keep their column order
    for r in range(n_out):
        assert (np.diff(cols[rows == r]) > 0).all()
    # the cut rows' segments first, slab-major, each inside one slab
    is_cut = cut[seg_row]
    n_cut = int(is_cut.sum())
    assert is_cut[:n_cut].all() and not is_cut[n_cut:].any()
    first, last = seg_ptr[:-1], np.maximum(seg_ptr[1:] - 1, seg_ptr[:-1])
    slab = cols[np.minimum(first, nnz - 1)] // slab_rows
    key = slab[:n_cut] * n_out + seg_row[:n_cut]
    assert (np.diff(key) >= 0).all()
    assert (cols[last[:n_cut]] // slab_rows == slab[:n_cut]).all()
    # then the other rows, whole, in row order
    rest = seg_row[n_cut:]
    np.testing.assert_array_equal(rest, np.flatnonzero(~cut))
    # partial slots: a split row's in the schedule's (slab) order
    per_row = np.bincount(seg_row, minlength=n_out)
    for r in range(n_out):
        segs = np.flatnonzero(seg_row == r)
        if per_row[r] == 1:
            assert seg_part[segs[0]] == -1
            assert row_part_ptr[r + 1] == row_part_ptr[r]
        else:
            np.testing.assert_array_equal(
                seg_part[segs],
                np.arange(row_part_ptr[r], row_part_ptr[r + 1]))
    assert row_part_ptr[-1] == (seg_part >= 0).sum()
    # row 7 (every x row) has a piece in every slab
    assert len(np.unique(cols[rows == 7] // slab_rows)) == -(-N_X // slab_rows)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("seg_len,slab_rows", SLAB_CASES)
def test_slabbed_product_matches_unslabbed_and_dense(seg_len, slab_rows, d):
    csr = slab_csr()
    op = T.row_operand(csr, False).resegment(seg_len)
    slabbed = op.schedule(slab_rows)
    assert slabbed.n_slab == -(-N_X // slab_rows)
    assert slabbed.n_seg >= op.n_seg and slabbed.nnz == op.nnz
    # x shorter than the grid: its last 100 rows read as zero
    x = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (N_X - 100, d)).astype(np.float32))
    y = T.spmm_rows(slabbed, x)
    plain = T.spmm_rows(op, x)   # the same terms, summed in another order
    assert float((y - plain).norm() / plain.norm()) < 1e-6
    want = torch.from_numpy(csr.toarray()[:, :N_X - 100]).double() @ x.double()
    for got in (y, plain):
        assert float((got - want).norm() / want.norm()) < 1e-6
    assert not y[3].any()
    # back to the CSR's order: the operand it came from, tensor for tensor
    back = slabbed.schedule(0)
    for name in T.RowOperand._TENSORS:
        assert torch.equal(getattr(back, name), getattr(op, name)), name
    assert (back.n_part, back.n_slab, back.seg_len) == (op.n_part, 1,
                                                        seg_len)


def spread_or_not(spread):
    """600 x 1000 CSR: its x rows uniform, or 97% of draws on x rows 0-39."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 600, 24_000)
    cols = rng.integers(0, 1000, 24_000)
    if not spread:
        cols = np.where(rng.random(24_000) < 0.97, cols % 40, cols)
    m = sp.csr_matrix((np.ones(24_000, np.float32), (rows, cols)),
                      shape=(600, 1000))
    m.sum_duplicates()
    m.sort_indices()
    return m


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("seg_len", [8, T.ROW_SEGMENT])
@pytest.mark.parametrize("spread", [True, False])
def test_the_rule_slabs_gathers_that_spread_past_the_l2(spread, seg_len, d):
    """Rows of about 40 nonzeros: cut at segments of 8, none cut at 128
    (the schedule keeps the CSR's order, one slab)."""
    op = T.row_operand(spread_or_not(spread), True).resegment(seg_len)
    l2 = 80 * 4 * d    # the L2 holds 80 x rows
    assert (op.spread_rows > 80) == spread
    before = {name: getattr(op, name) for name in T.RowOperand._TENSORS}
    assert T.launch_schedule(op, d, l2) is op
    slabbed = spread and seg_len == 8
    if spread:
        assert op.slab_rows == int(T.SLAB_L2_SHARE * l2) // (4 * d)
    else:
        assert op.slab_rows == 0
    if slabbed:
        assert op.n_slab == -(-1000 // op.slab_rows) and op.n_slab > 1
        assert f"n_slab={op.n_slab}" in repr(op)
    else:
        assert op.n_slab == 1
        for name, t in before.items():
            assert torch.equal(getattr(op, name), t), name
    # the schedule is kept: a second launch at this width builds nothing
    kept = {name: getattr(op, name) for name in T.RowOperand._TENSORS}
    T.launch_schedule(op, d, l2)
    assert all(getattr(op, n) is t for n, t in kept.items())
    # a card whose L2 holds the spread rows takes the CSR's order back
    T.launch_schedule(op, d, 1000 * 4 * d)
    assert (op.slab_rows, op.n_slab) == (0, 1)
    for name, t in before.items():
        assert torch.equal(getattr(op, name), t), name


@pytest.mark.parametrize("seg_len,slab_rows", SLAB_CASES[:4])
def test_operand_counts_read_alike_on_both_schedules(seg_len, slab_rows):
    from h100bench import costs_lightgcn as C

    op = T.row_operand(slab_csr(), True).resegment(seg_len)
    plain, slabbed = (C.operand_counts(o)
                      for o in (op, op.schedule(slab_rows)))
    for k in ("nnz", "n_out", "x_rows"):
        assert plain[k] == slabbed[k], k
    assert slabbed["n_seg"] >= plain["n_seg"]
    assert slabbed["split_rows"] >= plain["split_rows"]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n_rows,n_cols,density,br,bc,d", [
    (300, 260, 0.03, 128, 128, 64),
    (90, 300, 0.05, 8, 128, 50),
    (70, 50, 0.1, 8, 16, 130),
    (50, 70, 0.1, 16, 8, 24),
])
def test_row_product_matches_jax_reference(n_rows, n_cols, density, br, bc,
                                           d, transpose):
    m = matrix(3, n_rows, n_cols, density, br, bc)
    a = T.to_block_sparse(m, br, bc)
    op = a.t_rows if transpose else a.fwd_rows
    x = np.random.default_rng(4).standard_normal(
        (n_rows if transpose else n_cols, d)).astype(np.float32)
    want = np.asarray(J.spmm_reference(J.to_block_sparse(m, br, bc),
                                       jnp.asarray(x), transpose))
    for seg_len in (T.ROW_SEGMENT, 5):
        y = T.spmm_rows_reference(op.resegment(seg_len), torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), want, **TOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_row_product_matches_jax_pallas_interpret(transpose):
    m = matrix(10, 40, 136, 0.08, 8, 128)
    x = np.random.default_rng(11).standard_normal(
        (40 if transpose else 136, 16)).astype(np.float32)
    a = T.to_block_sparse(m, 8, 128)
    y = T.spmm_rows_reference(a.t_rows if transpose else a.fwd_rows,
                              torch.from_numpy(x)).numpy()
    y_pallas = np.asarray(J.spmm(J.to_block_sparse(m, 8, 128),
                                 jnp.asarray(x), transpose, interpret=True))
    np.testing.assert_allclose(y, y_pallas, **TOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_whole_hybrid_operand_matches_jax_hybrid_spmm(transpose):
    m = matrix(7, 120, 96, 0.03, 8, 16)
    x = np.random.default_rng(8).standard_normal(
        (120 if transpose else 96, 20)).astype(np.float32)
    th = T.to_hybrid(m, br=8, bc=16, min_fill=4)
    op = th.t_rows if transpose else th.fwd_rows
    jh = J.to_hybrid(m, br=8, bc=16, min_fill=4)
    want = np.asarray(J.hybrid_spmm(J.hybrid_meta(jh), J.hybrid_arrays(jh),
                                    jnp.asarray(x), transpose,
                                    interpret=True))
    for seg_len in (T.ROW_SEGMENT, 3):
        y = T.spmm_rows_reference(op.resegment(seg_len), torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), want, **TOL)


def test_propagate_hybrid_matches_jax_interpret():
    rng = np.random.default_rng(12)
    r = sp.random(60, 140, density=0.06, random_state=np.random.RandomState(
        12), format="csr", dtype=np.float32)
    r.data[:] = 1.0
    u0 = rng.standard_normal((60, 16)).astype(np.float32)
    i0 = rng.standard_normal((140, 16)).astype(np.float32)
    th = TG.normalized_bipartite_hybrid(r)
    u, i = TG.propagate_rows(torch.from_numpy(u0), torch.from_numpy(i0),
                             th.fwd_rows, th.t_rows, 2)
    jh = JG.normalized_bipartite_hybrid(r)
    ju, ji = JG.propagate_hybrid(jnp.asarray(u0), jnp.asarray(i0),
                                 J.hybrid_meta(jh), J.hybrid_arrays(jh), 2,
                                 interpret=True)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(i.numpy(), np.asarray(ji), **TOL)


def test_short_x_and_empty_operand():
    """x rows past x.shape[0] read as zero; an empty matrix gives zeros."""
    m = matrix(5, 40, 50, 0.2, 8, 16)
    op = T.to_block_sparse(m, 8, 16).fwd_rows
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (45, 8)).astype(np.float32))
    want = torch.from_numpy(m.toarray()[:, :45]).float() @ x
    torch.testing.assert_close(T.spmm_rows(op, x)[:40], want, **TOL)
    empty = T.to_block_sparse(sp.coo_matrix((20, 30), dtype=np.float32),
                              8, 16)
    assert empty.fwd_rows.nnz == 0 and empty.fwd_rows.n_seg == 24
    y = T.spmm_rows(empty.t_rows, torch.ones(24, 4))
    assert y.shape == (32, 4) and not y.any()


def test_cpu_operand_moves_and_refuses_a_mismatch():
    h = T.to_hybrid(matrix(9, 64, 80, 0.1, 8, 16), br=8, bc=16)
    moved = h.to("cpu")
    for op, src in ((moved.fwd_rows, h.fwd_rows), (moved.t_rows, h.t_rows)):
        for name in T.RowOperand._TENSORS:
            assert torch.equal(getattr(op, name), getattr(src, name))
        assert op._counts() == src._counts()
    with pytest.raises(ValueError, match="operand on cpu"):
        T.spmm_rows(h.fwd_rows, torch.ones(80, 4, device="meta"))
    T.reset_launch_counts()
    T.hybrid_spmm(h, torch.ones(80, 4))
    assert T.LAUNCHES == {"spmm_rows_fwd": 0, "spmm_rows_t": 0}
    assert T.SLABBED == {"spmm_rows_fwd": 0, "spmm_rows_t": 0}
