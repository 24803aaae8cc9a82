"""Weight bridge between the JAX package's param tree and the port.

The JAX tree (given as numpy arrays, nested dicts and lists) and the port's
``state_dict`` name the same parameters one for one:

    emb_layer.{w, b}         <-> emb_layer.{weight, bias}
    cat_layer.{w, b}         <-> cat_layer.{weight, bias}
    in_layers[N].{w, b}      <-> in_layers.N.{weight, bias}
    in_layers2[N].{w, b}     <-> in_layers2.N.{weight, bias}
    out_layers[N].{w, b}     <-> out_layers.N.{weight, bias}
    gcn/conv{1,2}/{w, b}     <-> gcn.conv{1,2}.{weight, bias}
    enc{1,2}[N]/{qkv, out, ff1, ff2}/{w, b}
                             <-> enc{1,2}.N.{qkv, out, ff1, ff2}.{weight, bias}
    enc{1,2}[N]/ln{1,2}/{g, b}
                             <-> enc{1,2}.N.ln{1,2}.{weight, bias}
    embedding_{item,user}    <-> embedding_{item,user}   (as stored)
    sumW                     <-> sumW                    (0-d)
    frozen_lgn_{user,item}   <-> frozen_lgn_{user,item}

Every ``w`` is transposed: the JAX package stores [d_in, d_out] and
computes ``x @ w``; ``nn.Linear`` stores [out, in]. A LayerNorm's gain
``g`` is ``nn.LayerNorm``'s 1-D ``weight`` (a Linear weight is 2-D, so the
rank tells the two apart on the way back). Any other leaf keeps its name
and layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def state_dict_from_jax_params(params: Any) -> Dict[str, np.ndarray]:
    """JAX param tree (numpy leaves) -> flat state_dict of numpy arrays."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                if k == "w":
                    out[prefix + "weight"] = np.ascontiguousarray(
                        np.asarray(v).T)
                elif k == "g":
                    out[prefix + "weight"] = np.asarray(v)
                elif k == "b":
                    out[prefix + "bias"] = np.asarray(v)
                else:
                    walk(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            out[prefix[:-1]] = np.asarray(node)

    walk(params, "")
    return out


def jax_params_from_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat state_dict (tensors or arrays) -> JAX param tree of numpy."""
    tree: Dict[str, Any] = {}
    for name, value in sd.items():
        value = (value.detach().cpu().numpy() if hasattr(value, "detach")
                 else np.asarray(value))
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if leaf == "weight" and value.ndim == 1:
            node["g"] = value
        elif leaf == "weight":
            node["w"] = np.ascontiguousarray(value.T)
        elif leaf == "bias":
            node["b"] = value
        else:
            node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)
