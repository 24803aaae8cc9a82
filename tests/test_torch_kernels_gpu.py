"""The port's CUDA and Triton kernels against their plain versions, on the
card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
The file imports nothing of JAX, so on a machine with a card and no JAX it
runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

SpMM tolerance rtol 1e-4 / atol 1e-5, TF32 off on the plain side: the
kernels sum the same float32 terms in another order. AdamW tolerance:
``fused_adamw.update_bounds`` (one ulp of a moment's storage type plus a
few float32 ulps of its terms, from fused multiply-adds).
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
    """COO with an empty row tile, an empty column tile and duplicates."""
    m = sp.random(n_rows, n_cols, density=density,
                  random_state=np.random.RandomState(seed), format="coo",
                  dtype=np.float32)
    keep = ~(((m.row >= br) & (m.row < 2 * br))
             | ((m.col >= bc) & (m.col < 2 * bc)))
    r, c, v = m.row[keep], m.col[keep], m.data[keep]
    dup = np.random.default_rng(seed).integers(0, len(r), 32)
    return sp.coo_matrix((np.concatenate([v, v[dup]]),
                          (np.concatenate([r, r[dup]]),
                           np.concatenate([c, c[dup]]))),
                         shape=(n_rows, n_cols))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("br,bc,d", [(8, 128, 64), (128, 128, 50),
                                     (16, 8, 100), (8, 16, 24)])
def test_kernel_matches_plain(cuda, br, bc, d, transpose):
    # 1000 rows at br 8 put 125 tiles in a column tile: two CSC segments
    m = matrix(1, 1000, 700, 0.03, br, bc)
    a = T.to_block_sparse(m, br, bc).to(cuda)
    n_x = 1000 if transpose else 700
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (n_x - 3, d)).astype(np.float32)).to(cuda)   # x shorter than grid
    name = "spmm_csc_t" if transpose else "spmm_csr_fwd"
    before = T.LAUNCHES[name]
    y = T.spmm(a, x, transpose)
    torch.cuda.synchronize()
    assert T.LAUNCHES[name] == before + 1
    torch.testing.assert_close(y, T.spmm_reference(a, x, transpose), **TOL)
    empty = slice(bc, 2 * bc) if transpose else slice(br, 2 * br)
    assert not y[empty].any(), "an empty tile must give zeros"


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
    u, i = TG.propagate_hybrid(u0, i0, h, 2)
    assert T.LAUNCHES == {"spmm_csr_fwd": 2, "spmm_csc_t": 2}
    up, ip = TG._layers(u0, i0, 2,
                        lambda x: T.hybrid_spmm_reference(h, x, False),
                        lambda x: T.hybrid_spmm_reference(h, x, True))
    torch.testing.assert_close(u, up, **TOL)
    torch.testing.assert_close(i, ip, **TOL)


def test_cuda_operand_refuses_instead_of_falling_back(cuda):
    a = T.to_block_sparse(matrix(4, 64, 64, 0.1, 8, 16), 8, 16).to(cuda)
    a.blocks = a.blocks.double()
    with pytest.raises(ValueError, match="blocks"):
        T.spmm(a, torch.ones(64, 8, device=cuda))
    big = T.to_block_sparse(matrix(5, 300, 300, 0.05, 256, 128), 256, 128)
    with pytest.raises(ValueError, match="tiles of 256x128"):
        T.spmm(big.to(cuda), torch.ones(300, 8, device=cuda))


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
