"""``parallel.layers.linear_parts`` on one device (``LinearParts``) against
``layer(cat(parts, -1))``: the output, the weight's, the bias's and each
part's gradient, over weight types, part layouts and which parts need a
gradient; its counters; and, under ``torch.profiler``, that no product
forms the [B, sum of widths] input gradient.

The loss is linear in the output (fixed random coefficients), so both
forms back-propagate the same output gradient. The output and the weight's
and bias's gradients come from the same products as the layer's and are
equal to the bit; a part's gradient is its own narrower product, so it may
differ by the order of float32 sums.
"""

import pytest

torch = pytest.importorskip("torch")

from gdmcf_torch.models.layers import linear_init  # noqa: E402
from gdmcf_torch.parallel.layers import LinearParts, linear_parts  # noqa: E402

B, D = 6, 5

N, E = 13, 3   # catalog width, time-embedding width

LAYOUTS = ["plain", "strided", "repeated"]

# (weight type, bias type): float32; param_dtype (both bfloat16); a
# bf16_weights pattern that matches the weight alone
DTYPES = {"float32": (torch.float32, torch.float32),
          "bf16": (torch.bfloat16, torch.bfloat16),
          "bf16_weight": (torch.bfloat16, torch.float32)}


def make_parts(layout: str, grads: str, gen: torch.Generator):
    """The parts of ``layout`` (the towers' calls: ``[x, emb]``, the
    noise-type-1 ``[x_U[:, :n], emb]``, the noise-type-2 ``[x, x, emb]``)
    and the leaves whose gradients are compared. ``grads``: which parts
    need a gradient (``none``, ``emb``: the time embedding, as in the
    towers, ``all``)."""
    x = torch.rand(B, N, generator=gen)
    x_u = torch.rand(B, 2 * N, generator=gen)
    emb = torch.randn(B, E, generator=gen)
    leaves = {"x": x, "x_u": x_u, "emb": emb}
    for name, t in leaves.items():
        t.requires_grad_(grads == "all" or (grads == "emb"
                                            and name == "emb"))
    parts = {"plain": [x, emb],
             "strided": [x_u[:, :N], emb],
             "repeated": [x, x, emb]}[layout]
    return parts, leaves


def run(layer, parts, leaves, coef, form):
    """(output, weight grad, bias grad, {leaf: grad}) of one form."""
    layer.zero_grad(set_to_none=True)
    for t in leaves.values():
        t.grad = None
    if form == "parts":
        y = linear_parts(layer, parts)
    else:
        y = layer(torch.cat(parts, dim=-1))
    if y.requires_grad:
        (y * coef).sum().backward()
    return (y.detach(), layer.weight.grad, layer.bias.grad,
            {k: t.grad for k, t in leaves.items()})


@pytest.mark.parametrize("grads", ["none", "emb", "all"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtypes", list(DTYPES))
def test_linear_parts_matches_the_concatenated_layer(dtypes, layout, grads):
    gen = torch.Generator().manual_seed(7)
    parts, leaves = make_parts(layout, grads, gen)
    layer = linear_init(sum(p.shape[-1] for p in parts), D, gen)
    w_dt, b_dt = DTYPES[dtypes]
    layer.weight.data = layer.weight.data.to(w_dt)
    layer.bias.data = layer.bias.data.to(b_dt)
    coef = torch.randn(B, D, generator=gen)
    y, gw, gb, gx = run(layer, parts, leaves, coef, "parts")
    y0, gw0, gb0, gx0 = run(layer, parts, leaves, coef, "cat")
    for got, want, dtype in ((y, y0, torch.float32), (gw, gw0, w_dt),
                             (gb, gb0, b_dt)):
        assert got.dtype == want.dtype == dtype
        assert torch.equal(got, want)
    for k, t in leaves.items():
        if t.requires_grad and gx0[k] is not None:
            assert gx[k].dtype == torch.float32
            torch.testing.assert_close(gx[k], gx0[k], rtol=1e-5, atol=1e-6)
        else:
            assert gx[k] is None
    with torch.no_grad():
        assert torch.equal(linear_parts(layer, parts), y0)
    with torch.inference_mode():
        assert torch.equal(linear_parts(layer, parts), y0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_linear_parts_counts_calls_and_skipped_columns(layout, monkeypatch):
    for name in ("calls", "skipped_columns"):
        monkeypatch.setattr(LinearParts, name, 0)
    gen = torch.Generator().manual_seed(3)
    parts, leaves = make_parts(layout, "emb", gen)
    layer = linear_init(sum(p.shape[-1] for p in parts), D, gen)
    linear_parts(layer, parts).sum().backward()
    with torch.no_grad():
        linear_parts(layer, parts)
    assert LinearParts.calls == 2
    # every part but the time embedding is data
    assert LinearParts.skipped_columns == sum(p.shape[-1]
                                              for p in parts[:-1])


def products(layer, parts, form):
    """[(op, input shapes)] of every product that one forward and backward
    of ``form`` runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        if form == "parts":
            y = linear_parts(layer, parts)
        else:
            y = layer(torch.cat(parts, dim=-1))
        y.sum().backward()
    return [(e.name, e.input_shapes) for e in prof.events()
            if e.name in ("aten::mm", "aten::addmm", "aten::matmul",
                          "aten::linear")]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_linear_parts_forms_no_whole_input_gradient(layout):
    gen = torch.Generator().manual_seed(5)
    parts, _ = make_parts(layout, "emb", gen)
    width = sum(p.shape[-1] for p in parts)
    layer = linear_init(width, D, gen)
    whole = [B, D], [D, width]   # dY @ W: the [B, width] input gradient

    def forms_whole(ops):
        return any(list(map(list, shapes[:2])) == list(map(list, whole))
                   for _, shapes in ops)

    # the concatenated layer does form it (the check sees what it looks
    # for); the parts never do
    ref = products(layer, parts, "cat")
    assert forms_whole(ref)
    ops = products(layer, parts, "parts")
    assert not forms_whole(ops), ops
    # one input-gradient product, the time embedding's [B, e]
    assert sum(1 for op, s in ops
               if op == "aten::mm" and list(s[0]) == [B, D]) == 1, ops


def test_linear_parts_refuses_parts_of_the_wrong_width():
    gen = torch.Generator().manual_seed(1)
    layer = linear_init(16, D, gen)
    with pytest.raises(RuntimeError):
        linear_parts(layer, [torch.rand(B, 13), torch.rand(B, 4)])
