"""K1's float32-master form against the JAX package's master branch.

For a tensor stored in bfloat16 the update runs on its float32 master and
writes the master and its rounding (``adamw_master_update_``; the kernel's
``MASTER`` branch on a CUDA tensor, ``adamw_master_reference`` on a CPU
one). The JAX counterpart is ``_adamw_leaf_inline`` on the master followed
by the storage cast, the branch of ``fused_adamw_apply`` taken for a leaf
with a master.

Tolerance: ``fused_adamw.master_update_bounds``: the master, mu and nu as
``update_bounds`` on the master (one ulp of a moment's storage type plus a
few float32 ulps of its terms, from fused multiply-adds); the stored
tensor within that plus one bfloat16 ulp. The kernel-against-plain case
is in ``tests/test_torch_kernels_gpu.py`` (it needs the card).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch import compat  # noqa: E402
from gdmcf_torch.ops import fused_adamw as TA  # noqa: E402
from gdmcf_tpu.ops import fused_adamw as JA  # noqa: E402

LR = 1e-3


def t_(a):
    return compat.to_tensor(np.asarray(a))


def over(got, want, bound):
    return int(((got.float() - want.float()).abs() > bound).sum())


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("shape", [(300, 260), (37,), ()])
def test_master_reference_matches_jax_on_the_master(moment_dtype, wd, shape):
    """Three successive steps (count 1 to 3), each from the same inputs in
    both packages: the JAX inline update of the master, then its cast."""
    rng = np.random.default_rng(1)
    master = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    mdt = jnp.dtype(moment_dtype)
    mu = jnp.zeros(shape, mdt)
    nu = jnp.zeros(shape, mdt)
    for count in (1, 2, 3):
        p = jnp.asarray(master).astype(jnp.bfloat16)
        g = jnp.asarray(rng.standard_normal(shape) * 0.1).astype(
            jnp.bfloat16)
        cf = jnp.float32(count)
        c1, c2 = 1.0 - 0.9 ** cf, 1.0 - 0.999 ** cf
        wm, wmu, wnu = JA._adamw_leaf_inline(
            jnp.asarray(master), g, mu, nu, c1, c2, b1=0.9, b2=0.999,
            eps=1e-8, lr=LR, wd=wd)
        wp = wm.astype(p.dtype)
        c = TA.step_scalars(torch.tensor(count, dtype=torch.int32), LR)
        args = (t_(p), t_(g), t_(mu), t_(nu), t_(master), c)
        gp, gmu, gnu, gm = TA.adamw_master_reference(*args, wd=wd)
        assert gp.dtype == torch.bfloat16 and gm.dtype == torch.float32
        assert gmu.dtype == {"float32": torch.float32,
                             "bfloat16": torch.bfloat16}[moment_dtype]
        bp, bmu, bnu, bm = TA.master_update_bounds(*args, wd=wd)
        for got, want, bound, what in ((gp, wp, bp, "p"), (gmu, wmu, bmu, "mu"),
                                       (gnu, wnu, bnu, "nu"),
                                       (gm, wm, bm, "master")):
            assert over(got, t_(want), bound) == 0, what
        # the stored tensor is the master's rounding, exactly
        assert torch.equal(gp, gm.to(torch.bfloat16))
        master, mu, nu = np.asarray(wm), wmu, wnu


def test_fused_adamw_apply_matches_the_jax_master_branch():
    """A tree of bfloat16- and float32-stored tensors: the port's
    ``fused_adamw_apply`` (master form where a master exists) against the
    JAX ``fused_adamw_apply`` with its masters, three steps."""
    rng = np.random.default_rng(2)
    shapes = {"w": (40, 30), "b": (30,), "s": ()}
    jparams = {k: jnp.asarray(rng.standard_normal(s) * 0.1,
                              jnp.float32) for k, s in shapes.items()}
    jparams["w"] = jparams["w"].astype(jnp.bfloat16)
    jparams["b"] = jparams["b"].astype(jnp.bfloat16)
    mask = {k: True for k in shapes}
    jstate = JA.fused_adamw_init(jparams, mask, moment_dtype=jnp.bfloat16)
    assert set(jstate.master) == {"w", "b"}
    params = {k: torch.nn.Parameter(t_(v), requires_grad=False)
              for k, v in jparams.items()}
    state = TA.fused_adamw_init(params, torch.bfloat16)
    assert set(state.master) == {"w", "b"}
    for k, m in state.master.items():
        assert torch.equal(m, t_(jstate.master[k]))
    TA.reset_launch_counts()
    for _ in range(3):
        jgrads = {k: jnp.asarray(rng.standard_normal(s) * 0.1).astype(
            jparams[k].dtype) for k, s in shapes.items()}
        grads = {k: t_(v) for k, v in jgrads.items()}
        jparams, jstate = JA.fused_adamw_apply(
            jparams, jgrads, jstate, mask, lr=LR, weight_decay=0.01)
        state = TA.fused_adamw_apply(params, grads, state, lr=LR,
                                     weight_decay=0.01)
        for k in shapes:
            got, want = params[k].detach(), t_(jparams[k])
            assert got.dtype == want.dtype
            bound = (torch.finfo(got.dtype).eps * want.float().abs()
                     + 1e-6)
            assert over(got, want, bound) == 0, k
        for k in ("w", "b"):
            torch.testing.assert_close(state.master[k],
                                       t_(jstate.master[k]),
                                       rtol=1e-6, atol=1e-7)
    # CPU tensors take the plain version: no launch of either form
    assert TA.LAUNCHES == {"fused_adamw": 0, "fused_adamw_master": 0}
    assert int(state.count) == 3


def test_master_form_on_cpu_updates_in_place():
    p = torch.nn.Parameter(torch.full((3, 4), 1.0, dtype=torch.bfloat16))
    params = {"p": p}
    state = TA.fused_adamw_init(params, torch.float32)
    ptr, mptr = p.data_ptr(), state.master["p"].data_ptr()
    grads = {"p": torch.full((3, 4), 0.25, dtype=torch.bfloat16)}
    state = TA.fused_adamw_apply(params, grads, state, lr=1e-3)
    # Adam's first step moves the master by lr against the gradient; the
    # stored value, 0.999 rounded to bfloat16, is 1.0 again (the bfloat16
    # below 1 is 1 - 2^-8)
    assert p.data_ptr() == ptr and state.master["p"].data_ptr() == mptr
    torch.testing.assert_close(state.master["p"], torch.full((3, 4), 0.999))
    assert torch.equal(p.detach(), torch.full((3, 4), 1.0,
                                              dtype=torch.bfloat16))
    for _ in range(4):
        state = TA.fused_adamw_apply(params, grads, state, lr=1e-3)
    # five steps of lr: the master is 0.995, which the storage follows
    assert torch.equal(p.detach(), state.master["p"].to(torch.bfloat16))
    assert p.detach().float().max() == 1.0 - 2.0 ** -8
