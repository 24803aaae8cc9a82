"""Denoiser backbones.

Port of the JAX package's ``models/backbones.py``, every model family of
the reference:

    DNN, DNN_conti          plain MLP denoiser (conti: two unused tables)
    DNNCat, DNNCat2         x fused with the one-hot corruption first
    DNNOneHot               two towers, concatenated, then ``out_layers``
    DNNOneHotEmbedding      towers, NT-Xent, user table, cosine head
                            (``conti=True``: DNNOneHotEmbedding_conti)
    DNNOneHotEmbeddingGCN   the flagship: the above plus a GCN and a blend
                            (``conti=True``: DNNOneHotEmbeddingGCN_conti)
    DNNOneHotTransformer    transformer-encoder towers
    DNNlightGCN             LightGCN link filter in front of a DNN

Every forward takes ``(x, t, x_U, index, graph)`` and the keywords
``rcloss`` (return the contrastive loss), ``generator`` and ``dropout_u``
(pre-drawn dropout uniforms, in the order the JAX package splits its
dropout keys) and returns ``(scores, closs or None)``; dropout follows
``self.training``. A backbone ignores the inputs it does not read.

Each class carries the flags of the JAX package's ``ModelDef``:
``needs_onehot`` (it reads ``x_U``), ``needs_index`` (the reference's
indexIn path: it reads ``index`` and asks for the contrastive loss) and
``needs_graph`` (it reads ``graph``, so the noise_scale=0 reverse path,
which grows none, cannot serve it).

On a (dp, mp) mesh the ops that touch a catalog-sharded tensor take their
mesh forms (``parallel/layers.py``, ``parallel/embed.py``; the same op when
the tensor is whole). On a dp-sharded batch the trainer draws the whole
batch's dropout uniforms (``dropout_draws``) and sets ``contrastive_group``,
so that NT-Xent reads the whole batch's latents.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gdmcf_torch.models.gcn import LayerGCN, layer_gcn_user_rows
from gdmcf_torch.models.layers import (dropout, l2_normalize, linear_init,
                                       mlp_init, mlp_out, nt_xent_loss,
                                       timestep_embedding,
                                       torch_linear_default, xavier_uniform)
from gdmcf_torch.parallel.collectives import gather_from, gather_rows
from gdmcf_torch.parallel.embed import lookup_rows
from gdmcf_torch.parallel.layers import cosine_head, linear_out, linear_parts
from gdmcf_torch.parallel.sharding import shard_of


def _tower_dims(in_dims: List[int], emb_size: int) -> List[int]:
    """Prepend the time-embedding width to the first layer."""
    return [in_dims[0] + emb_size] + list(in_dims[1:])


def _onehot_dims(in_dims: List[int], emb_size: int) -> List[int]:
    """The one-hot tower's widths: the [B, n, 2] corruption flattened."""
    return _tower_dims([in_dims[0] * 2] + list(in_dims[1:]), emb_size)


def _tower(layers: nn.ModuleList, parts, act=torch.tanh) -> torch.Tensor:
    """``act`` after every layer over ``cat(parts, -1)``; the first layer
    may hold a catalog-sharded weight (``linear_parts``)."""
    h = act(linear_parts(layers[0], parts))
    for layer in layers[1:]:
        h = act(layer(h))
    return h


class _Denoiser(nn.Module):
    """What every backbone has: the time embedding's ``emb_layer``, the
    optional input normalization and the dropout rate."""

    def __init__(self, emb_size: int, generator: torch.Generator, device,
                 norm: bool, dropout_rate: float):
        super().__init__()
        self.emb_size = emb_size
        self.norm = norm
        self.dropout_rate = dropout_rate
        self.emb_layer = linear_init(emb_size, emb_size, generator, device)

    def _time(self, t):
        return self.emb_layer(timestep_embedding(t, self.emb_size))

    def _dropout_widths(self, n: int) -> Sequence[int]:
        """The widths of the [B, w] inputs the forward drops out, in its
        order, for a catalog of n items."""
        raise NotImplementedError

    def dropout_draws(self, batch_size: int, n: int, generator,
                      keep=lambda t: t) -> tuple:
        """The dropout uniforms the forward draws itself (none in eval mode
        or at rate 0), for ``dropout_u``; ``keep`` maps each as it is
        made (a dp block keeps its rows of the whole batch's)."""
        if not self.training or self.dropout_rate == 0.0:
            return ()
        dev = self.emb_layer.weight.device
        return tuple(keep(torch.rand((batch_size, w), generator=generator,
                                     device=dev))
                     for w in self._dropout_widths(n))


# ---------------------------------------------------------------------------
# DNN family: one MLP over [x || time embedding]
# ---------------------------------------------------------------------------

class DNN(_Denoiser):
    """The plain MLP denoiser: tanh ``in_layers`` over ``[x || emb]``, then
    ``out_layers`` with tanh between. Subclasses change the input
    (``_features``) or the activation (``act``)."""

    needs_onehot = False
    needs_index = False
    needs_graph = False
    act = staticmethod(torch.tanh)

    def __init__(self, in_dims, out_dims, emb_size: int,
                 generator: torch.Generator, device=None, norm: bool = False,
                 dropout_rate: float = 0.5):
        super().__init__(emb_size, generator, device, norm, dropout_rate)
        assert out_dims[0] == in_dims[-1], \
            "In and out dimensions must equal to each other."
        self.in_layers = mlp_init(_tower_dims(in_dims, emb_size), generator,
                                  device)
        self.out_layers = mlp_init(out_dims, generator, device)

    def _features(self, x, x_U, index):
        return x

    def _dropout_widths(self, n):
        return (n,)

    def forward(self, x, t, x_U=None, index=None, graph=None,
                rcloss: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_u: Sequence[torch.Tensor] = ()):
        x = self._features(x, x_U, index)
        emb = self._time(t)
        if self.norm:
            x = l2_normalize(x)
        (u,) = dropout_u or (None,)
        h = _tower(self.in_layers,
                   [dropout(x, self.dropout_rate, self.training, generator,
                            u), emb], act=self.act)
        return mlp_out(self.out_layers, h, act=self.act), None


class DNN_conti(DNN):
    """DNN plus two embedding tables that the forward never reads: they
    are parameters in the reference (experiment residue), so they are here
    too, and train with zero gradients."""

    def __init__(self, in_dims, out_dims, emb_size: int, n_item: int,
                 n_user: int, generator: torch.Generator, device=None,
                 norm: bool = False, dropout_rate: float = 0.5):
        super().__init__(in_dims, out_dims, emb_size, generator, device,
                         norm, dropout_rate)
        d_user = _tower_dims(in_dims, emb_size)[-1]
        self.embedding_item = nn.Parameter(
            xavier_uniform((n_item, 2 * d_user), generator, device))
        self.embedding_user = nn.Parameter(
            xavier_uniform((n_user, d_user), generator, device))


class DNNCat(DNN):
    """Each item's [x, x_U0, x_U1] through one shared 3 -> 1 ``cat_layer``
    before the DNN."""

    needs_onehot = True

    def __init__(self, in_dims, out_dims, emb_size: int,
                 generator: torch.Generator, device=None, norm: bool = False,
                 dropout_rate: float = 0.5, cat_dim: int = 2):
        super().__init__(in_dims, out_dims, emb_size, generator, device,
                         norm, dropout_rate)
        self.cat_layer = linear_init(cat_dim + 1, 1, generator, device)

    def _features(self, x, x_U, index):
        return self.cat_layer(torch.cat([x[..., None], x_U],
                                        dim=2)).squeeze(-1)


class DNNCat2(DNN):
    """All items' [x, x_U0, x_U1] (interleaved, 3n wide) through a 3n -> n
    ``cat_layer`` and tanh before the DNN; relu in both stacks."""

    needs_onehot = True
    act = staticmethod(torch.relu)

    def __init__(self, in_dims, out_dims, emb_size: int,
                 generator: torch.Generator, device=None, norm: bool = False,
                 dropout_rate: float = 0.5, cat_dim: int = 2):
        super().__init__(in_dims, out_dims, emb_size, generator, device,
                         norm, dropout_rate)
        n = in_dims[0]
        self.cat_layer = linear_init((cat_dim + 1) * n, n, generator, device)

    def _features(self, x, x_U, index):
        xc = torch.cat([x[..., None], x_U], dim=2).reshape(x.shape[0], -1)
        return torch.tanh(linear_out(self.cat_layer, xc))


class DNNlightGCN(DNN):
    """LightGCN link filter in front of a plain DNN denoiser.

    The reference scores every (user, item) edge with LightGCN embeddings
    propagated over the frozen train graph and keeps the edges whose
    sigmoid score exceeds 0.5. The threshold blocks every gradient to the
    embeddings, so they keep their init values and one propagation at
    construction is exact: ``frozen_lgn_user``/``frozen_lgn_item`` are
    buffers, and the filter is ``(e_user[index] @ e_item.T) > 0``.

    ``norm_adj``: dense normalized N (a [n_user, n_item] tensor);
    ``sparse_adj``: a BlockSparse or HybridSparse N, propagated on its row
    operands alone (the SpMM kernel on CUDA). Neither: the raw init tables are used.
    """

    needs_index = True

    def __init__(self, in_dims, out_dims, emb_size: int, n_user: int,
                 n_item: int, generator: torch.Generator, device=None,
                 norm: bool = False, dropout_rate: float = 0.5,
                 lgn_dim: int = 64, lgn_layers: int = 2,
                 norm_adj: Optional[torch.Tensor] = None, sparse_adj=None):
        # the LightGCN table is drawn first, so that a caller can redraw the
        # raw table from the same seed (see draw_lgn_table)
        e_user, e_item = self.draw_lgn_table(n_user, n_item, lgn_dim,
                                             generator, device)
        super().__init__(in_dims, out_dims, emb_size, generator, device,
                         norm, dropout_rate)
        if sparse_adj is not None:
            from gdmcf_torch.models.lightgcn import propagate_rows
            dev = e_user.device
            e_user, e_item = propagate_rows(
                e_user, e_item, sparse_adj.fwd_rows.to(dev),
                sparse_adj.t_rows.to(dev), lgn_layers)
        elif norm_adj is not None:
            from gdmcf_torch.models.lightgcn import propagate
            e_user, e_item = propagate(e_user, e_item,
                                       norm_adj.to(e_user.device), lgn_layers)
        self.register_buffer("frozen_lgn_user", e_user.contiguous())
        self.register_buffer("frozen_lgn_item", e_item.contiguous())

    @staticmethod
    def draw_lgn_table(n_user: int, n_item: int, lgn_dim: int,
                       generator: torch.Generator, device=None):
        """The raw Xavier-uniform (user, item) tables, before propagation."""
        emb = xavier_uniform((n_user + n_item, lgn_dim), generator, device)
        return emb[:n_user], emb[n_user:]

    def _features(self, x, x_U, index):
        items = self.frozen_lgn_item
        link = ((lookup_rows(self.frozen_lgn_user, index) @ items.T)
                > 0.0).to(x.dtype)
        shard = shard_of(items)
        if shard is not None:   # this rank's item columns of the filter
            link = gather_from(link, shard.group, 1)
        return x * link


# ---------------------------------------------------------------------------
# one-hot family: a tower over x and a tower over the [B, n, 2] corruption
# ---------------------------------------------------------------------------

class _OneHotInputs(_Denoiser):
    """The inputs every one-hot backbone prepares alike: the corruption
    flattened interleaved, (cell 0 state 0, cell 0 state 1, ...), the
    layout the second tower's rows are bridged in; the time embedding;
    optional normalization; dropout of both (uniforms ``dropout_u[0]`` for
    x and ``dropout_u[1]`` for x_U)."""

    def _inputs(self, x, t, x_U, generator, dropout_u):
        u_x, u_xu = tuple(dropout_u[:2]) or (None, None)
        x_U = x_U.reshape(x_U.shape[0], -1)
        emb = self._time(t)
        if self.norm:
            x, x_U = l2_normalize(x), l2_normalize(x_U)
        x = dropout(x, self.dropout_rate, self.training, generator, u_x)
        x_U = dropout(x_U, self.dropout_rate, self.training, generator, u_xu)
        return x, x_U, emb

    def _dropout_widths(self, n):
        return (n, 2 * n)


class DNNOneHot(_OneHotInputs):
    """Two tanh towers, concatenated, then ``out_layers``."""

    needs_onehot = True
    needs_index = False
    needs_graph = False

    def __init__(self, in_dims, out_dims, emb_size: int,
                 generator: torch.Generator, device=None, norm: bool = False,
                 dropout_rate: float = 0.5):
        super().__init__(emb_size, generator, device, norm, dropout_rate)
        assert out_dims[0] == in_dims[-1]
        in_t2 = _onehot_dims(in_dims, emb_size)
        self.in_layers = mlp_init(_tower_dims(in_dims, emb_size), generator,
                                  device)
        self.in_layers2 = mlp_init(in_t2, generator, device)
        self.out_layers = mlp_init(
            [out_dims[0] + in_t2[-1]] + list(out_dims[1:]), generator, device)

    def forward(self, x, t, x_U=None, index=None, graph=None,
                rcloss: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_u: Sequence[torch.Tensor] = ()):
        x, x_U, emb = self._inputs(x, t, x_U, generator, dropout_u)
        h = _tower(self.in_layers, [x, emb])
        h_U = _tower(self.in_layers2, [x_U, emb])
        return mlp_out(self.out_layers, torch.cat([h, h_U], dim=1)), None


class DNNOneHotEmbedding(_OneHotInputs):
    """Two tanh towers -> NT-Xent between them -> fused with a learned
    user table -> full-catalog cosine scores against a learned item table.
    ``conti=True`` is ``DNNOneHotEmbedding_conti``: the fused vector uses
    the one-hot tower twice. Subclasses transform the fused vector
    (``_blend``)."""

    needs_onehot = True
    needs_index = True
    needs_graph = False
    noise_type = 0   # the tower routing of the GCN subclass; 0 is none
    # the dp group a training batch is split over (the trainer sets it on
    # a mesh with dp > 1): NT-Xent then runs over the whole batch
    contrastive_group = None

    def __init__(self, in_dims, out_dims, emb_size: int, n_item: int,
                 n_user: int, generator: torch.Generator, device=None,
                 norm: bool = False, dropout_rate: float = 0.5,
                 conti: bool = False, cosine_eps: float = 0.0):
        super().__init__(emb_size, generator, device, norm, dropout_rate)
        assert out_dims[0] == in_dims[-1]
        in_t = _tower_dims(in_dims, emb_size)
        in_t2 = _onehot_dims(in_dims, emb_size)
        d_user = in_t[-1]
        self.conti = conti
        self.cosine_eps = cosine_eps
        self.in_layers = mlp_init(in_t, generator, device)
        self.in_layers2 = mlp_init(in_t2, generator, device)
        self.embedding_item = nn.Parameter(xavier_uniform(
            (n_item, in_t[-1] + d_user + in_t2[-1]), generator, device))
        self.embedding_user = nn.Parameter(
            xavier_uniform((n_user, d_user), generator, device))

    def _blend(self, hc, graph):
        return hc

    def forward(self, x, t, x_U=None, index=None, graph=None,
                rcloss: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_u: Sequence[torch.Tensor] = ()):
        x, x_U, emb = self._inputs(x, t, x_U, generator, dropout_u)
        routed = not self.conti
        if routed and self.noise_type == 1:
            h = _tower(self.in_layers, [x_U[:, : x.shape[1]], emb])
        else:
            h = _tower(self.in_layers, [x, emb])
        if routed and self.noise_type == 2:
            h_U = _tower(self.in_layers2, [x, x, emb])
        else:
            h_U = _tower(self.in_layers2, [x_U, emb])

        closs = None
        if rcloss:
            z, z_U = h, h_U
            if self.contrastive_group is not None:
                # over the whole batch: a dp block gathers the others'
                # latents (the gradient returns to each block's rows)
                z = gather_rows(h, self.contrastive_group)
                z_U = gather_rows(h_U, self.contrastive_group)
            closs = nt_xent_loss(z, z_U)
            if routed and self.noise_type != 0:
                closs = closs * 0.0

        user_vecs = lookup_rows(self.embedding_user, index)
        hc = torch.cat([h_U if self.conti else h, h_U, user_vecs], dim=1)
        hc = self._blend(hc, graph)
        return cosine_head(hc, self.embedding_item, self.cosine_eps), closs


class DNNOneHotEmbeddingGCN(DNNOneHotEmbedding):
    """The flagship backbone: ``DNNOneHotEmbedding`` whose fused vector
    goes through a GCN over the corruption graph and a learnable ``sumW``
    blend before the cosine head.

    ``conti=True`` is ``DNNOneHotEmbeddingGCN_conti``: the fused vector
    uses the one-hot tower twice and ``noise_type`` routing is skipped.
    ``noise_type`` 1 feeds the first tower the one-hot tower's first n
    columns, 2 feeds the second tower ``[x, x]``; both zero the
    contrastive loss. The GCN hidden width is 512, as in the reference.
    """

    needs_graph = True   # forward reads ``graph``; p_sample must grow one
    GCN_HIDDEN = 512

    def __init__(self, in_dims, out_dims, emb_size: int, n_item: int,
                 n_user: int, generator: torch.Generator, device=None,
                 norm: bool = False, dropout_rate: float = 0.5,
                 gcn_layer_num: int = 2, noise_type: int = 0,
                 symmetric_gcn: bool = False, conti: bool = False,
                 cosine_eps: float = 0.0):
        super().__init__(in_dims, out_dims, emb_size, n_item, n_user,
                         generator, device, norm, dropout_rate, conti,
                         cosine_eps)
        d_item = self.embedding_item.shape[1]
        self.gcn_layer_num = gcn_layer_num
        self.noise_type = noise_type
        self.symmetric_gcn = symmetric_gcn
        self.gcn = LayerGCN(d_item, self.GCN_HIDDEN, d_item,
                            max(gcn_layer_num, 1), generator, device)
        self.sumW = nn.Parameter(torch.ones((), device=device))

    def _blend(self, hc, graph):
        if self.gcn_layer_num == 0:
            return hc
        if self.symmetric_gcn:
            g = graph[..., 1].to(hc.dtype)
            gcn_u, _ = self.gcn(hc, self.embedding_item, g, symmetric=True)
        else:
            # directed graph: the user rows the blend reads ignore it
            gcn_u = layer_gcn_user_rows(self.gcn, hc)
        return hc * self.sumW + gcn_u * (1.0 - self.sumW)


# ---------------------------------------------------------------------------
# DNNOneHotTransformer: transformer-encoder towers
# ---------------------------------------------------------------------------

class EncoderLayer(nn.Module):
    """torch's post-norm ``TransformerEncoderLayer`` with a relu FFN, at
    torch's default inits: ``qkv`` (the attention's in-projection)
    Xavier-uniform with a zero bias, ``out`` Linear-default with a zero
    bias, ``ff1``/``ff2`` Linear-default; LayerNorm eps 1e-5 (biased
    variance).

    The reference feeds [B, d_model] with no sequence axis, so torch reads
    the batch as the sequence of one sentence and attention mixes across
    batch rows: seq_len = B. Dropout at the layer's rate hits the attention
    weights, the attention output, the FFN's inner activation and its
    output. ``dropout_u``: uniforms in the JAX package's key order (the
    attention output [B, d], the FFN output [B, d], the attention weights
    [nhead, B, B], the FFN inner activation [B, d_ff])."""

    def __init__(self, d_model: int, d_ff: int, nhead: int,
                 dropout_rate: float, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.nhead = nhead
        self.dropout_rate = dropout_rate
        self.qkv = nn.Linear(d_model, 3 * d_model, device=device)
        with torch.no_grad():
            self.qkv.weight.copy_(xavier_uniform((d_model, 3 * d_model),
                                                 generator, device).T)
            self.qkv.bias.zero_()
        self.out = torch_linear_default(d_model, d_model, generator, device)
        with torch.no_grad():
            self.out.bias.zero_()
        self.ff1 = torch_linear_default(d_model, d_ff, generator, device)
        self.ff2 = torch_linear_default(d_ff, d_model, generator, device)
        self.ln1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                dropout_u: Sequence[torch.Tensor] = ()):
        u_ctx, u_ff, u_att, u_inner = tuple(dropout_u) or (None,) * 4
        rate, train = self.dropout_rate, self.training
        b, d = x.shape
        hd = d // self.nhead

        def heads(z):
            return z.reshape(b, self.nhead, hd).transpose(0, 1)  # [H, B, hd]

        q, k, v = (heads(z) for z in self.qkv(x).chunk(3, dim=-1))
        att = torch.softmax((q @ k.transpose(1, 2)) / math.sqrt(hd), dim=-1)
        att = dropout(att, rate, train, generator, u_att)
        ctx = self.out((att @ v).transpose(0, 1).reshape(b, d))
        x = self.ln1(x + dropout(ctx, rate, train, generator, u_ctx))
        inner = dropout(F.relu(self.ff1(x)), rate, train, generator, u_inner)
        ff = self.ff2(inner)
        return self.ln2(x + dropout(ff, rate, train, generator, u_ff))


class DNNOneHotTransformer(_OneHotInputs):
    """Two stacks of ``num_layers`` encoder layers replace the MLP towers
    (d_model = the tower's input width, d_ff = its output width); the two
    outputs, concatenated, go through ``out_layers``.

    ``dropout_u``: x's and x_U's uniforms, then four per layer (see
    ``EncoderLayer``), ``enc1``'s layers first, then ``enc2``'s."""

    needs_onehot = True
    needs_index = False
    needs_graph = False

    def _dropout_widths(self, n):
        raise NotImplementedError(
            "DNNOneHotTransformer's dropout includes [nhead, B, B] attention "
            "weights, which a dp block cannot cut from the whole batch's")

    def __init__(self, in_dims, out_dims, emb_size: int,
                 generator: torch.Generator, device=None, norm: bool = False,
                 dropout_rate: float = 0.5, nhead: int = 2,
                 num_layers: int = 2):
        super().__init__(emb_size, generator, device, norm, dropout_rate)
        assert out_dims[0] == in_dims[-1]
        in_t = _tower_dims(in_dims, emb_size)
        in_t2 = _onehot_dims(in_dims, emb_size)
        self.enc1 = nn.ModuleList(
            EncoderLayer(in_t[0], in_t[-1], nhead, dropout_rate, generator,
                         device) for _ in range(num_layers))
        self.enc2 = nn.ModuleList(
            EncoderLayer(in_t2[0], in_t2[-1], nhead, dropout_rate, generator,
                         device) for _ in range(num_layers))
        self.out_layers = mlp_init([in_t2[0] + in_t[0]] + list(out_dims[1:]),
                                   generator, device)

    def forward(self, x, t, x_U=None, index=None, graph=None,
                rcloss: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_u: Sequence[torch.Tensor] = ()):
        x, x_U, emb = self._inputs(x, t, x_U, generator, dropout_u)
        h = torch.cat([x, emb], dim=-1)
        h_U = torch.cat([x_U, emb], dim=-1)
        layers = list(self.enc1) + list(self.enc2)
        for i, layer in enumerate(layers):
            u = tuple(dropout_u[2 + 4 * i: 6 + 4 * i])
            if i < len(self.enc1):
                h = layer(h, generator, u)
            else:
                h_U = layer(h_U, generator, u)
        return mlp_out(self.out_layers, torch.cat([h, h_U], dim=1)), None
