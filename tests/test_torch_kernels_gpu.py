"""The port's CUDA and Triton kernels against their plain versions, on the
card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
The file imports nothing of JAX, so on a machine with a card and no JAX it
runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

SpMM tolerance rtol 1e-4 / atol 1e-5, TF32 off on the plain side: the
kernel sums the same float32 terms in another order. The same tolerance
holds the gradients through the differentiable product (``spmm_op``, whose
backward pass is the kernel in the other direction) against the plain
versions and dense autograd; their plain sums run with deterministic
``index_add_``. AdamW tolerance:
``fused_adamw.update_bounds`` (one ulp of a moment's storage type plus a
few float32 ulps of its terms, from fused multiply-adds); its master form
within ``fused_adamw.master_update_bounds`` (the same on the master, the
bfloat16 tensor within one more bfloat16 ulp).
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from gdmcf_torch.models import lightgcn as TG  # noqa: E402
from gdmcf_torch.ops import fused_adamw as TA  # noqa: E402
from gdmcf_torch.ops import spmm as T  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def matrix(seed, n_rows, n_cols, density, br, bc):
    """COO with an empty row tile, an empty column tile, duplicates, and a
    dense row and column (rows of several ROW_SEGMENT segments in A and
    A^T)."""
    m = sp.random(n_rows, n_cols, density=density,
                  random_state=np.random.RandomState(seed), format="coo",
                  dtype=np.float32)
    keep = ~(((m.row >= br) & (m.row < 2 * br))
             | ((m.col >= bc) & (m.col < 2 * bc)))
    r, c, v = m.row[keep], m.col[keep], m.data[keep]
    dup = np.random.default_rng(seed).integers(0, len(r), 32)
    # the dense row and column miss the empty tiles
    dr = np.setdiff1d(np.arange(n_rows), np.arange(br, 2 * br))
    dc = np.setdiff1d(np.arange(n_cols), np.arange(bc, 2 * bc))
    half = np.full(len(dr) + len(dc), 0.5, np.float32)
    return sp.coo_matrix(
        (np.concatenate([v, v[dup], half]),
         (np.concatenate([r, r[dup], dr, np.full(len(dc), 2 * br + 1)]),
          np.concatenate([c, c[dup], np.full(len(dr), 2 * bc + 3), dc]))),
        shape=(n_rows, n_cols))


def rand_x(seed, n, d, cuda):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)).to(cuda)


def name_of(transpose):
    return "spmm_rows_t" if transpose else "spmm_rows_fwd"


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("br,bc,d", [(8, 128, 64), (128, 128, 50),
                                     (16, 8, 100), (8, 16, 24)])
def test_kernel_matches_plain(cuda, br, bc, d, transpose):
    m = matrix(1, 1000, 700, 0.03, br, bc)
    a = T.to_block_sparse(m, br, bc).to(cuda)
    op = a.t_rows if transpose else a.fwd_rows
    assert op.n_part > 0, "no row cut into several segments"
    n_x = 1000 if transpose else 700
    x = rand_x(2, n_x - 3, d, cuda)            # x shorter than the grid
    before = T.LAUNCHES[name_of(transpose)]
    y = T.spmm(a, x, transpose)
    torch.cuda.synchronize()
    assert T.LAUNCHES[name_of(transpose)] == before + 1
    torch.testing.assert_close(y, T.spmm_rows_reference(op, x), **TOL)
    torch.testing.assert_close(y, T.spmm_reference(a, x, transpose), **TOL)
    empty = slice(bc, 2 * bc) if transpose else slice(br, 2 * br)
    assert not y[empty].any(), "an empty tile must give zeros"
    n_out = 700 if transpose else 1000
    assert not y[n_out:].any(), "pad rows must be zero"


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("seg_len", [1, 7, 4096])
def test_kernel_segments_and_determinism(cuda, seg_len, transpose):
    """Any cut of the rows gives the plain sum; two launches on the same
    inputs are bitwise equal."""
    h = T.to_hybrid(matrix(3, 600, 900, 0.02, 8, 128), br=8, bc=128,
                    min_fill=24)
    assert h.rem_vals.numel() > 1000
    op = (h.t_rows if transpose else h.fwd_rows).resegment(seg_len).to(cuda)
    x = rand_x(4, 600 if transpose else 900, 64, cuda)
    y = T.spmm_rows(op, x)
    again = T.spmm_rows(op, x)
    torch.cuda.synchronize()
    assert torch.equal(y, again), "two launches differ"
    torch.testing.assert_close(y, T.spmm_rows_reference(op, x), **TOL)
    torch.testing.assert_close(
        y, T.hybrid_spmm_reference(h.to(cuda), x, transpose), **TOL)


def slab_csr(seed, n_x, long_row):
    """A 64 x n_x CSR: short random rows, an empty row (3), a row over every
    x row (7) and one of ``long_row`` nonzeros in the first x rows (11)."""
    m = sp.random(64, n_x, density=0.02, format="lil", dtype=np.float32,
                  random_state=np.random.RandomState(seed))
    m[3, :] = 0
    m[7, :] = 0.5
    m[11, :long_row] = 0.25
    return m.tocsr()


@pytest.mark.parametrize("d", [64, 50])
@pytest.mark.parametrize("seg_len,l2_rows", [
    (T.ROW_SEGMENT, 16), (T.ROW_SEGMENT, 600), (5, 16), (3, 200),
    (T.ROW_SEGMENT, 1 << 20)])
def test_kernel_on_a_slabbed_operand_matches_plain(cuda, monkeypatch,
                                                   seg_len, l2_rows, d):
    """On a card whose L2 holds ``l2_rows`` x rows the rule slabs the
    operand (not the last case); the launch then matches the plain sum on
    the slabbed and on the unslabbed schedule, two launches are bitwise
    equal, and each counts once in LAUNCHES and, slabbed, in SLABBED."""
    monkeypatch.setattr(T, "card_l2_bytes", lambda device: l2_rows * 4 * d)
    op = T.row_operand(slab_csr(1, 1200, 300), True).resegment(seg_len)
    plain = op.to(cuda)
    op = op.to(cuda)
    x = rand_x(2, 1100, d, cuda)               # x shorter than the grid
    T.reset_launch_counts()
    y = T.spmm_rows(op, x)
    again = T.spmm_rows(op, x)
    torch.cuda.synchronize()
    slabbed = op.spread_rows > l2_rows
    assert (op.n_slab > 1) == slabbed and op.seg_len == seg_len
    assert T.LAUNCHES == {"spmm_rows_fwd": 0, "spmm_rows_t": 2}
    assert T.SLABBED == {"spmm_rows_fwd": 0, "spmm_rows_t": 2 * slabbed}
    assert torch.equal(y, again), "two launches differ"
    torch.testing.assert_close(y, T.spmm_rows_reference(op, x), **TOL)
    torch.testing.assert_close(y, T.spmm_rows_reference(plain, x), **TOL)
    assert not y[3].any(), "an empty row must give zeros"


def test_a_row_of_thousands_of_partials_sums_right(cuda, monkeypatch):
    """Slabs of 8 x rows: a row over 20,000 x rows takes 2,500 partials,
    and one of 4,000 nonzeros 500 (2,000 at segments of 2)."""
    monkeypatch.setattr(T, "card_l2_bytes",
                        lambda device: int(8 * 4 * 64 / T.SLAB_L2_SHARE) + 1)
    csr = sp.vstack([slab_csr(3, 20_000, 0),
                     sp.csr_matrix((np.full(4000, 0.75, np.float32),
                                    (np.zeros(4000, int), np.arange(4000))),
                                   shape=(1, 20_000))]).tocsr()
    csr.sort_indices()
    x = rand_x(5, 20_000, 64, cuda)
    dense = torch.from_numpy(csr.toarray()).to(cuda)
    want = dense @ x
    # rows of 4,000-20,000 terms cancel down to a small sum: the rtol is
    # taken of the sum of the terms' magnitudes, the scale of its rounding
    scale = TOL["rtol"] * (dense.abs() @ x.abs()) + TOL["atol"]
    for seg_len in (T.ROW_SEGMENT, 2):
        op = T.row_operand(csr, False).resegment(seg_len).to(cuda)
        y = T.spmm_rows(op, x)
        torch.cuda.synchronize()
        assert op.slab_rows == 8 and op.n_slab == 2500
        per_row = torch.bincount(op.seg_row.long(), minlength=op.n_out)
        assert int(per_row[7]) >= 2500
        assert int(per_row[64]) == (2000 if seg_len == 2 else 500)
        for other in (T.spmm_rows_reference(op, x), want):
            assert bool(((y - other).abs() <= scale).all())


def test_the_cards_l2_slabs_only_the_spread_operand(cuda):
    """At the card's own L2, D 64: the transpose of a random 400,000 x
    1,000 graph (x: a 102 MB user table, its gathers spread over most of
    it) is slabbed; its forward (x: 1,000 item rows), and both directions
    of a power-law graph of Amazon-Book's size (108,822 x 94,949, 2.18M
    interactions, built as the registry's lightGCN backbone builds N), are
    not."""
    from h100bench.data import power_law_graph

    rng = np.random.default_rng(8)
    wide = sp.csr_matrix((np.ones(1_000_000, np.float32),
                          (rng.integers(0, 400_000, 1_000_000),
                           rng.integers(0, 1_000, 1_000_000))),
                         shape=(400_000, 1_000))
    wide.sum_duplicates()
    wide.data[:] = 1.0
    amazon = power_law_graph(2, 108_822, 94_949, 2_180_000)
    for graph, slabbed in ((wide, True), (amazon, False)):
        fwd, t = (op.to(cuda) for op in
                  TG.normalized_operand(graph, "hybrid", 128, 8))
        x = rand_x(7, fwd.n_out, 64, cuda)
        T.reset_launch_counts()
        T.spmm_rows(fwd, rand_x(6, t.n_out, 64, cuda))
        y = T.spmm_rows(t, x)
        torch.cuda.synchronize()
        assert T.LAUNCHES == {"spmm_rows_fwd": 1, "spmm_rows_t": 1}
        assert T.SLABBED == {"spmm_rows_fwd": 0, "spmm_rows_t": int(slabbed)}
        assert fwd.n_slab == 1 and (t.n_slab > 1) == slabbed
        assert t.slab_rows == (int(T.SLAB_L2_SHARE * T.card_l2_bytes(cuda))
                               // 256 if slabbed else 0)
        torch.testing.assert_close(y, T.spmm_rows_reference(t, x), **TOL)


def test_hybrid_propagation_matches_plain(cuda):
    rng = np.random.default_rng(3)
    r = sp.random(600, 900, density=0.02,
                  random_state=np.random.RandomState(3), format="csr",
                  dtype=np.float32)
    r.data[:] = 1.0
    h = TG.normalized_bipartite_hybrid(r).to(cuda)
    u0 = torch.from_numpy(rng.standard_normal((600, 64)).astype(
        np.float32)).to(cuda)
    i0 = torch.from_numpy(rng.standard_normal((900, 64)).astype(
        np.float32)).to(cuda)
    T.reset_launch_counts()
    u, i = TG.propagate_rows(u0, i0, h.fwd_rows, h.t_rows, 2)
    assert T.LAUNCHES == {"spmm_rows_fwd": 2, "spmm_rows_t": 2}
    up, ip = TG._layers(u0, i0, 2,
                        lambda x: T.hybrid_spmm_reference(h, x, False),
                        lambda x: T.hybrid_spmm_reference(h, x, True))
    torch.testing.assert_close(u, up, **TOL)
    torch.testing.assert_close(i, ip, **TOL)


def lgn_grad(prop, e0, w_u, w_i):
    e = e0.clone().requires_grad_(True)
    n_user = w_u.shape[0]
    fu, fi = prop(e[:n_user], e[n_user:])
    return torch.autograd.grad((fu * w_u).sum() + (fi * w_i).sum(), e)[0]


@pytest.mark.parametrize("d", [64, 50])
def test_product_backward_matches_plain_and_dense(cuda, d):
    """Gradients of a loss over both propagated tables (3 layers): the
    kernel both ways against the plain row gather, the plain tiles + COO
    and dense autograd; 3 + 3 launches forward and 3 + 3 backward; two
    backward passes bitwise equal."""
    r = sp.random(600, 900, density=0.02,
                  random_state=np.random.RandomState(5), format="csr",
                  dtype=np.float32)
    r.data[:] = 1.0
    h = TG.normalized_bipartite_hybrid(r, min_fill=32).to(cuda)
    assert h.rem_vals.numel() > 1000
    dense = torch.from_numpy(TG.normalized_bipartite_blocks(r)).to(cuda)
    e0, w_u, w_i = (rand_x(s, n, d, cuda)
                    for s, n in ((6, 1500), (7, 600), (8, 900)))
    T.reset_launch_counts()
    def prop(u, i):
        return TG.propagate_rows(u, i, h.fwd_rows, h.t_rows, 3)

    g = lgn_grad(prop, e0, w_u, w_i)
    torch.cuda.synchronize()
    assert T.LAUNCHES == {"spmm_rows_fwd": 6, "spmm_rows_t": 6}
    again = lgn_grad(prop, e0, w_u, w_i)
    torch.cuda.synchronize()
    assert torch.equal(g, again), "two backward passes differ"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        rows = lgn_grad(lambda u, i: TG._layers(
            u, i, 3, lambda x: T.spmm_rows_reference(h.fwd_rows, x),
            lambda x: T.spmm_rows_reference(h.t_rows, x)), e0, w_u, w_i)
        tiles = lgn_grad(lambda u, i: TG._layers(
            u, i, 3, lambda x: T.hybrid_spmm_reference(h, x, False),
            lambda x: T.hybrid_spmm_reference(h, x, True)), e0, w_u, w_i)
    finally:
        torch.use_deterministic_algorithms(False)
    full = lgn_grad(lambda u, i: TG.propagate(u, i, dense, 3), e0, w_u, w_i)
    for want in (rows, tiles, full):
        torch.testing.assert_close(g, want, **TOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_op_backward_launches_the_other_direction(cuda, transpose):
    """x shorter than the operand's columns: the forward launch reads the
    missing rows as zero, the backward launch (one, on the other operand)
    gives x's rows only."""
    a = T.to_block_sparse(matrix(9, 1000, 700, 0.03, 8, 128), 8, 128)
    a = a.to(cuda)
    n_x = (1000 if transpose else 700) - 5
    x = rand_x(10, n_x, 64, cuda).requires_grad_(True)
    w = rand_x(11, 1024, 64, cuda)
    T.reset_launch_counts()
    y = T.spmm(a, x, transpose)
    (y * w[:y.shape[0]]).sum().backward()
    torch.cuda.synchronize()
    assert T.LAUNCHES == {"spmm_rows_fwd": 1, "spmm_rows_t": 1}
    back = a.fwd_rows if transpose else a.t_rows
    want = T.spmm_rows_reference(back, w[:y.shape[0]])[:n_x]
    assert x.grad.shape == x.shape
    torch.testing.assert_close(x.grad, want, **TOL)
    with pytest.raises(ValueError, match="spmm_op"):
        T.spmm_rows(a.fwd_rows if not transpose else a.t_rows, x)


def test_pretrain_initial_table_is_the_cpu_one(cuda):
    """A seed gives pretrain the same starting table on the card as on the
    CPU."""
    want = TG.initial_table(1500, 64, 7, "cpu")
    got = TG.initial_table(1500, 64, 7, cuda)
    assert got.is_cuda and torch.equal(got.cpu(), want)


def test_cuda_operand_refuses_instead_of_falling_back(cuda):
    a = T.to_block_sparse(matrix(4, 64, 64, 0.1, 8, 16), 8, 16)
    x = torch.ones(64, 8, device=cuda)
    with pytest.raises(ValueError, match="operand on cpu"):
        T.spmm(a, x)
    with pytest.raises(ValueError, match="x on cpu"):
        T.spmm(a.to(cuda), x.cpu())
    a = a.to(cuda)
    with pytest.raises(ValueError, match=r"x must be \[n, D\]"):
        T.spmm_rows(a.fwd_rows, torch.ones(64, device=cuda))
    a.fwd_rows.vals = a.fwd_rows.vals.double()
    with pytest.raises(ValueError, match="vals"):
        T.spmm(a, x)


@pytest.mark.parametrize("moment_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("shape", [(), (1024,), (1000, 37), (65535,),
                                   (65537,), (300, 513)])
def test_adamw_kernel_matches_plain(cuda, shape, moment_dtype, wd):
    """Three successive steps (count 1 to 3), each from the same inputs."""
    gen = torch.Generator(cuda).manual_seed(0)
    p = torch.randn(shape, generator=gen, device=cuda)
    mu = torch.zeros(shape, dtype=moment_dtype, device=cuda)
    nu = torch.zeros(shape, dtype=moment_dtype, device=cuda)
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    for _ in range(3):
        g = 0.1 * torch.randn(shape, generator=gen, device=cuda)
        count = count + 1
        c = TA.step_scalars(count, 1e-3)
        want = TA.adamw_reference(p, g, mu, nu, c, wd=wd)
        bounds = TA.update_bounds(p, g, mu, nu, c, wd=wd)
        before = TA.LAUNCHES["fused_adamw"]
        TA.adamw_update_(p, g, mu, nu, c, wd=wd)
        torch.cuda.synchronize()
        assert TA.LAUNCHES["fused_adamw"] == before + 1
        for got, w, b, what in zip((p, mu, nu), want, bounds,
                                   ("p", "mu", "nu")):
            assert got.dtype == w.dtype
            over = (got.float() - w.float()).abs() > b
            assert not over.any(), f"{what}: {int(over.sum())} over bound"


@pytest.mark.parametrize("moment_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("shape", [(), (1024,), (1000, 37), (65537,)])
def test_adamw_master_form_matches_plain(cuda, shape, moment_dtype, wd):
    """The kernel's master form (a bfloat16 p and g, a float32 master)
    against ``adamw_master_reference``, three steps from the same inputs
    each, within ``master_update_bounds``; two launches bitwise equal."""
    gen = torch.Generator(cuda).manual_seed(1)
    m = 0.05 * torch.randn(shape, generator=gen, device=cuda)
    p = m.to(torch.bfloat16)
    mu = torch.zeros(shape, dtype=moment_dtype, device=cuda)
    nu = torch.zeros(shape, dtype=moment_dtype, device=cuda)
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    for _ in range(3):
        g = (0.1 * torch.randn(shape, generator=gen, device=cuda)).to(
            torch.bfloat16)
        count = count + 1
        c = TA.step_scalars(count, 1e-3)
        want = TA.adamw_master_reference(p, g, mu, nu, m, c, wd=wd)
        bounds = TA.master_update_bounds(p, g, mu, nu, m, c, wd=wd)
        twice = [t.clone() for t in (p, mu, nu, m)]
        before = TA.LAUNCHES["fused_adamw_master"]
        TA.adamw_master_update_(p, g, mu, nu, m, c, wd=wd)
        TA.adamw_master_update_(twice[0], g, twice[1], twice[2], twice[3],
                                c, wd=wd)
        torch.cuda.synchronize()
        assert TA.LAUNCHES["fused_adamw_master"] == before + 2
        for got, again in zip((p, mu, nu, m), twice):
            assert torch.equal(got, again)
        for got, w, b, what in zip((p, mu, nu, m), want, bounds,
                                   ("p", "mu", "nu", "master")):
            assert got.dtype == w.dtype
            over = (got.float() - w.float()).abs() > b
            assert not over.any(), f"{what}: {int(over.sum())} over bound"
        assert torch.equal(p, m.to(torch.bfloat16))
        # continue from the plain state: the next step starts from the
        # same inputs again
        p, mu, nu, m = want


def test_adamw_master_form_refuses_instead_of_falling_back(cuda):
    z = dict(device=cuda)
    p = torch.zeros(64, 32, dtype=torch.bfloat16, **z)
    good = dict(g=torch.zeros(64, 32, dtype=torch.bfloat16, **z),
                mu=torch.zeros(64, 32, dtype=torch.bfloat16, **z),
                nu=torch.zeros(64, 32, dtype=torch.bfloat16, **z),
                m=torch.zeros(64, 32, **z),
                c=TA.step_scalars(torch.ones((), dtype=torch.int32, **z),
                                  1e-3))
    for match, change in (
            ("master form", dict(m=torch.zeros(64, 32, dtype=torch.bfloat16,
                                               **z))),
            ("master form", dict(g=torch.zeros(64, 32, **z))),
            ("shape", dict(m=torch.zeros(64, 31, **z))),
            ("contiguous", dict(m=torch.zeros(32, 64, **z).T)),
            ("must be on", dict(m=torch.zeros(64, 32)))):
        a = dict(good, **change)
        with pytest.raises(ValueError, match=match):
            TA.adamw_master_update_(p, a["g"], a["mu"], a["nu"], a["m"],
                                    a["c"])
    # the plain form refuses a bfloat16 tensor and names the master form
    with pytest.raises(ValueError, match="master form"):
        TA.adamw_update_(p, good["g"], good["mu"], good["nu"], good["c"])


def test_adamw_cuda_tensor_refuses_instead_of_falling_back(cuda):
    p = torch.zeros(64, 32, device=cuda)
    good = dict(g=torch.zeros(64, 32, device=cuda),
                mu=torch.zeros(64, 32, dtype=torch.bfloat16, device=cuda),
                nu=torch.zeros(64, 32, dtype=torch.bfloat16, device=cuda),
                c=TA.step_scalars(torch.ones((), dtype=torch.int32,
                                             device=cuda), 1e-3))
    bad = [
        ("contiguous", dict(g=torch.zeros(32, 64, device=cuda).T)),
        ("shape", dict(g=torch.zeros(64, 31, device=cuda))),
        ("both float32 or both bfloat16",
         dict(nu=torch.zeros(64, 32, device=cuda))),
        ("both float32 or both bfloat16",
         dict(mu=torch.zeros(64, 32, dtype=torch.float16, device=cuda),
              nu=torch.zeros(64, 32, dtype=torch.float16, device=cuda))),
        ("must be on", dict(c=good["c"].cpu())),
        ("float32", dict(g=torch.zeros(64, 32, dtype=torch.float64,
                                       device=cuda))),
    ]
    for match, change in bad:
        args = dict(good, **change)
        with pytest.raises(ValueError, match=match):
            TA.adamw_update_(p, args["g"], args["mu"], args["nu"], args["c"])
    with pytest.raises(ValueError, match="contiguous"):
        TA.adamw_update_(torch.zeros(32, 64, device=cuda).T, good["g"],
                         good["mu"], good["nu"], good["c"])


def test_fused_call_graphs_equal_eager_steps(cuda):
    """``train_steps_per_call`` 4 (the first group eager, then its CUDA
    graph captured and replayed in both epochs, ``train/graphs.py``)
    against 1 on the card
    from one seed, two epochs: the parameters, moments, Lt, step count,
    loss sums and the generator's state bitwise; K1's launches counted as
    the eager ones plus captured x replays; ``evaluate_streaming`` at
    ``eval_batches_per_call`` 4 against 1: the same ids and results."""
    from gdmcf_torch.config import Config
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.ops import metrics as TM
    from gdmcf_torch.train.trainer import Trainer

    n_user, n_item = 170, 300
    rng = np.random.default_rng(0)
    train = sp.csr_matrix((rng.random((n_user, n_item)) < 0.05
                           ).astype(np.float32))
    data = NativeCSR.from_scipy(train)
    runs = []
    for k in (1, 4):
        cfg = Config(device="cuda", dims=[64], batch_size=16, steps=5,
                     noise_scale=1e-4, sampling_steps=2, sampling_noise=True,
                     train_steps_per_call=k, eval_batches_per_call=k,
                     topN=[10, 20])
        tr = Trainer(cfg, n_user, n_item)
        state = tr.init_state()
        TA.reset_launch_counts()
        totals = [tr.train_epoch(state, data, np.random.default_rng(e))[1]
                  for e in range(2)]
        launches = TA.LAUNCHES["fused_adamw"]
        ids = []
        add = TM.MetricAccumulator.add_packed

        def spy(self, gt, pred, n):
            ids.append(pred.clone())
            return add(self, gt, pred, n)

        TM.MetricAccumulator.add_packed = spy
        try:
            res = [tr.evaluate_streaming(state, [data], data, [data],
                                         [10, 20]) for _ in range(2)]
        finally:
            TM.MetricAccumulator.add_packed = add
        opt = state.opt_state
        snap = [t.detach().clone() for t in (
            *state.params.values(), *opt.mu.values(), *opt.nu.values(),
            opt.count, state.lt.history, state.lt.count)]
        runs.append((snap, totals, state.step, launches, ids, res,
                     state.generator.get_state(), tr))
    (s1, t1, n1, l1, i1, r1, g1, _), (s4, t4, n4, l4, i4, r4, g4, tr4) = runs
    assert n1 == n4 == 20 and t1 == t4 and r1 == r4
    assert torch.equal(g1, g4)
    assert all(torch.equal(a, b) for a, b in zip(s1, s4))
    assert len(i1) == len(i4) and all(torch.equal(a, b)
                                      for a, b in zip(i1, i4))
    graphs = tr4.graphs()
    train_g = list(graphs.train_graphs.values())
    # 10 batches an epoch: groups of 4, 4 and two single steps; the first
    # epoch's first group eager (the graph captured after it), every
    # later group replayed, the second epoch's first group too
    assert len(train_g) == 1 and train_g[0].replays == 3
    per_step = train_g[0].launches["fused_adamw"] // 4
    assert l1 == l4 == 20 * per_step
