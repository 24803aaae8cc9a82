"""Backbone registry (port of the JAX package's ``models/registry.py``).

Builds ``lightGCN`` and the flagship ``DNNOneHotEmbeddingGCN`` (and its
``_conti`` variant); every other backbone raises and names the ROADMAP.md
item that ports it.
"""

from __future__ import annotations

import torch

from gdmcf_torch.models.backbones import DNNlightGCN, DNNOneHotEmbeddingGCN

BACKBONES = (
    "DNN", "DNN_conti", "DNNCat", "DNNCat2", "DNNOneHot",
    "DNNOneHotTransformer", "DNNOneHotEmbedding", "DNNOneHotEmbedding_conti",
    "DNNOneHotEmbeddingGCN", "DNNOneHotEmbeddingGCN_conti", "lightGCN",
)
_FLAGSHIP = {"DNNOneHotEmbeddingGCN": False,
             "DNNOneHotEmbeddingGCN_conti": True}


def build_model(cfg, n_user: int, n_item: int, train_csr=None, *,
                generator: torch.Generator, device=None) -> torch.nn.Module:
    """``train_csr`` is the training interaction matrix; the lightGCN
    backbone propagates its link-filter tables over it: dense normalized N
    for moderate catalogs, the hybrid tile + COO operand once the dense N
    would exceed ``_DENSE_LIMIT_BYTES``."""
    b = cfg.backbone
    in_dims, out_dims = cfg.in_dims(n_item), cfg.out_dims(n_item)
    if b in _FLAGSHIP:
        # the corrected mode guards the cosine head's denominator
        return DNNOneHotEmbeddingGCN(
            in_dims, out_dims, cfg.emb_size, n_item, n_user,
            generator=generator, device=device, norm=cfg.norm,
            dropout_rate=cfg.dropout, gcn_layer_num=cfg.gcnLayerNum,
            noise_type=cfg.noise_type, symmetric_gcn=cfg.symmetric_gcn,
            conti=_FLAGSHIP[b], cosine_eps=0.0 if cfg.fidelity else 1e-8)
    if b != "lightGCN":
        if b not in BACKBONES:
            raise ValueError(f"not implemented backbone: {b}")
        raise NotImplementedError(
            f"backbone {b} is not ported yet: ROADMAP.md §A item 5 (other "
            "backbones)")
    norm_adj, sparse_adj = None, None
    if train_csr is not None:
        from gdmcf_torch.models import lightgcn as _lg

        if n_user * n_item * 4 > _lg._DENSE_LIMIT_BYTES:
            sparse_adj = _lg.normalized_bipartite_hybrid(train_csr)
        else:
            norm_adj = torch.from_numpy(
                _lg.normalized_bipartite_blocks(train_csr))
    return DNNlightGCN(in_dims, out_dims, cfg.emb_size, n_user, n_item,
                       generator=generator, device=device, norm=cfg.norm,
                       dropout_rate=cfg.dropout, norm_adj=norm_adj,
                       sparse_adj=sparse_adj)
