"""Backbone registry (port of the JAX package's ``models/registry.py``):
the reference's construction switch over the 11 backbone names."""

from __future__ import annotations

import torch

from gdmcf_torch.models import backbones as B

BACKBONES = (
    "DNN", "DNN_conti", "DNNCat", "DNNCat2", "DNNOneHot",
    "DNNOneHotTransformer", "DNNOneHotEmbedding", "DNNOneHotEmbedding_conti",
    "DNNOneHotEmbeddingGCN", "DNNOneHotEmbeddingGCN_conti", "lightGCN",
)
# the backbones built from (in_dims, out_dims, emb_size) alone
_PLAIN = {"DNN": B.DNN, "DNNCat": B.DNNCat, "DNNCat2": B.DNNCat2,
          "DNNOneHot": B.DNNOneHot,
          "DNNOneHotTransformer": B.DNNOneHotTransformer}


def build_model(cfg, n_user: int, n_item: int, train_csr=None, *,
                generator: torch.Generator, device=None) -> torch.nn.Module:
    """``train_csr`` is the training interaction matrix; the lightGCN
    backbone propagates its link-filter tables over it: the dense
    normalized N for moderate catalogs, N's row operands over the 8 x 128
    grid once the dense N would exceed the limit of
    ``lightgcn.normalized_operand``."""
    b = cfg.backbone
    in_dims, out_dims = cfg.in_dims(n_item), cfg.out_dims(n_item)
    common = dict(generator=generator, device=device, norm=cfg.norm,
                  dropout_rate=cfg.dropout)
    # the corrected mode guards the cosine head's denominator
    emb_kw = dict(cosine_eps=0.0 if cfg.fidelity else 1e-8,
                  conti=b.endswith("_conti"))
    if b in _PLAIN:
        return _PLAIN[b](in_dims, out_dims, cfg.emb_size, **common)
    if b == "DNN_conti":
        return B.DNN_conti(in_dims, out_dims, cfg.emb_size, n_item, n_user,
                           **common)
    if b in ("DNNOneHotEmbedding", "DNNOneHotEmbedding_conti"):
        return B.DNNOneHotEmbedding(in_dims, out_dims, cfg.emb_size, n_item,
                                    n_user, **common, **emb_kw)
    if b in ("DNNOneHotEmbeddingGCN", "DNNOneHotEmbeddingGCN_conti"):
        return B.DNNOneHotEmbeddingGCN(
            in_dims, out_dims, cfg.emb_size, n_item, n_user,
            gcn_layer_num=cfg.gcnLayerNum, noise_type=cfg.noise_type,
            symmetric_gcn=cfg.symmetric_gcn, **common, **emb_kw)
    if b != "lightGCN":
        raise ValueError(f"not implemented backbone: {b}")
    norm_adj, sparse_adj = None, None
    if train_csr is not None:
        from gdmcf_torch.models.lightgcn import normalized_operand

        a = normalized_operand(train_csr, None, block_size=128, block_rows=8)
        dense = isinstance(a, torch.Tensor)
        norm_adj, sparse_adj = (a, None) if dense else (None, a)
    return B.DNNlightGCN(in_dims, out_dims, cfg.emb_size, n_user, n_item,
                         norm_adj=norm_adj, sparse_adj=sparse_adj, **common)
