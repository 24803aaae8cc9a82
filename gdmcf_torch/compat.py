"""Weight bridges: the JAX package's param tree <-> the port, and trained
reference (PyTorch) checkpoints -> the port.

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
and layout. ``tree_path`` gives a parameter's JAX path (``in_layers/0/w``),
which ``bf16_weights`` patterns match. bfloat16 leaves cross as bfloat16:
numpy has no such type of its own, so the JAX side's arrays carry the
``ml_dtypes`` one (``to_tensor`` reads its bits; ``to_numpy`` writes it
where ``ml_dtypes`` imports, and widens to float32, exactly, where not).

Reference checkpoints. The reference saves its best model as a whole-module
pickle (``torch.save(model, 'model.pth')``) and its LightGCN pretrainer's
tables as four ``*_Embed.pt`` files. A user moving a trained run onto this
system imports them here:

    params = import_reference_checkpoint("model.pth", cfg, n_user, n_item)

or writes a port checkpoint (step 0, fresh optimizer state) that ``fit``
can resume and ``serve``/``serve_http --ckpt_dir_serve`` can serve:

    python -m gdmcf_torch.compat model.pth -c configs/yelpOneEmbGcn.yaml \
        --device cpu --data_path ./Datasets/yelp_clean/ --out ./ckpt

Accepted inputs: a ``state_dict`` saved with ``torch.save``, an ``.npz`` of
it, or a whole-module pickle whose classes are importable. The reference
is PyTorch too, so its names map onto the port's with no transpose:

    emb_layer.{weight,bias}          -> emb_layer.{weight,bias}
    in_layers.N / in_layers2.N /
      out_layers.N .{weight,bias}    -> the same names
    embedding_{item,user}.weight     -> embedding_{item,user}
    gcn_model.convK.lin.weight       -> gcn.convK.weight   (GCNConv linear)
    gcn_model.convK.bias             -> gcn.convK.bias
    sumW                             -> sumW

``out_layers.*`` entries are skipped when the model has no ``out_layers``
(the reference builds but bypasses them in the embedding backbones). The
names the JAX package's importer does not know (``cat_layer``, the
transformer's ``enc*``) are refused here too.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np


def tree_path(name: str, ndim: int) -> str:
    """The JAX package's path of the port's parameter ``name`` (its
    ``path_str``): dots become slashes and the leaf takes the JAX name, a
    2-D ``weight`` ``w``, a 1-D one ``g``, ``bias`` ``b``; e.g.
    ``in_layers.0.weight`` -> ``in_layers/0/w``."""
    *path, leaf = name.split(".")
    if leaf == "weight":
        leaf = "g" if ndim == 1 else "w"
    elif leaf == "bias":
        leaf = "b"
    return "/".join(path + [leaf])


def _bfloat16_numpy():
    """numpy's bfloat16 type where ``ml_dtypes`` provides one, else None."""
    try:
        return np.dtype("bfloat16")
    except TypeError:
        try:
            import ml_dtypes
        except ImportError:
            return None
        return np.dtype(ml_dtypes.bfloat16)


def to_tensor(a):
    """A numpy array (bfloat16 ones included) -> a CPU tensor of its
    type, a copy."""
    import torch

    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a, order="C").view(np.int16)   # a copy, 0-d kept
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(t) -> np.ndarray:
    """A tensor -> a numpy array of its type (a bfloat16 tensor as
    ``ml_dtypes`` bfloat16, or float32 without it)."""
    import torch

    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bf16 = _bfloat16_numpy()
        if bf16 is None:
            return t.float().numpy()
        return t.contiguous().view(torch.int16).numpy().view(bf16)
    return t.numpy()


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
        value = (to_numpy(value) if hasattr(value, "detach")
                 else np.asarray(value))
        *path, leaf = tree_path(name, value.ndim).split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(value.T) if leaf == "w" else value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


# ---------------------------------------------------------------------------
# reference (PyTorch) checkpoints -> the port
# ---------------------------------------------------------------------------

def _resolve(name: str, groups) -> Optional[str]:
    """Reference state_dict name -> the port's parameter name, or None to
    skip. ``groups``: the first dotted part of every parameter name."""
    m = re.fullmatch(r"(in_layers2?|out_layers)\.(\d+)\.(weight|bias)", name)
    if m:
        if m.group(1) not in groups:
            if m.group(1) == "out_layers":
                return None   # constructed but bypassed in the reference
            raise KeyError(f"model has no parameter group {m.group(1)!r}")
        return name
    if re.fullmatch(r"emb_layer\.(weight|bias)", name):
        return name
    m = re.fullmatch(r"embedding_(item|user)\.weight", name)
    if m:
        return f"embedding_{m.group(1)}"
    m = re.fullmatch(r"gcn_model\.(conv\d)\.lin\.weight", name)
    if m:
        return f"gcn.{m.group(1)}.weight"
    m = re.fullmatch(r"gcn_model\.(conv\d)\.bias", name)
    if m:
        return f"gcn.{m.group(1)}.bias"
    if name == "sumW":
        return "sumW"
    raise KeyError(f"unrecognized reference parameter {name!r}")


def params_from_state_dict(sd: Mapping[str, Any],
                           template: Mapping[str, Any]) -> Dict[str, Any]:
    """Reference weights by name -> {the port's parameter name: CPU tensor}
    in the template's dtypes. ``template``: the model's parameters by name
    (``dict(model.named_parameters())``), read for names, shapes and
    dtypes only. Raises on unknown names, shape mismatches and template
    parameters the state_dict leaves unfilled (a silent partial import is
    worse than an error)."""
    groups = {k.split(".")[0] for k in template}
    out: Dict[str, Any] = {}
    for name, value in sd.items():
        value = (to_numpy(value) if hasattr(value, "detach")
                 else np.asarray(value))
        target = _resolve(name, groups)
        if target is None:
            continue
        if target not in template:
            raise KeyError(f"reference parameter {name!r} maps to "
                           f"{target!r}, which the model does not have")
        want = template[target]
        if tuple(want.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {target}: checkpoint "
                             f"{value.shape} vs model {tuple(want.shape)}")
        out[target] = to_tensor(value).to(want.dtype)
    missing = sorted(set(template) - set(out))
    if missing:
        raise ValueError(f"state_dict left model parameters unfilled: "
                         f"{missing}")
    return out


def _load_state_dict(path: str) -> Mapping[str, np.ndarray]:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    import torch
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError) as e:
        raise ModuleNotFoundError(
            f"{path} is a whole-module pickle whose classes do not import "
            "here; re-export it as a state_dict (torch.save(model."
            "state_dict(), ...)) or an .npz and import that") from e
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: to_numpy(v) for k, v in obj.items()}


def import_reference_embeddings(src_dir: str, out_dir: Optional[str] = None):
    """The reference LightGCN pretrainer's four ``*_Embed.pt`` files in
    ``src_dir`` (final and initial, user and item) as a
    ``models.lightgcn.LightGCNResult`` of float32 arrays; with ``out_dir``
    also written as this package's ``lightgcn_embeddings.npz``."""
    import torch

    from gdmcf_torch.models.lightgcn import LightGCNResult, save_embeddings

    def load(name):
        t = torch.load(os.path.join(src_dir, f"{name}_Embed.pt"),
                       map_location="cpu", weights_only=True)
        return np.asarray(t.detach().numpy(), dtype=np.float32)

    fu, fi = load("final_user"), load("final_item")
    iu, ii = load("initial_user"), load("initial_item")
    if fu.ndim != 2 or fi.ndim != 2:
        raise ValueError(
            f"embedding artifacts must be 2-D [rows, dim]; got final_user "
            f"{fu.shape}, final_item {fi.shape}")
    if fu.shape != iu.shape or fi.shape != ii.shape or \
            fu.shape[1] != fi.shape[1]:
        raise ValueError(
            f"inconsistent embedding shapes: final {fu.shape}/{fi.shape}, "
            f"initial {iu.shape}/{ii.shape}")
    result = LightGCNResult(final_user=fu, final_item=fi,
                            initial_user=iu, initial_item=ii)
    if out_dir is not None:
        save_embeddings(result, out_dir)
    return result


def import_reference_checkpoint(path: str, cfg, n_user: int, n_item: int,
                                train_csr=None) -> Dict[str, Any]:
    """A reference checkpoint file -> {parameter name: CPU tensor} for the
    port's model of ``cfg`` (built on the CPU as the template;
    ``train_csr``: the interactions, for the lightGCN backbone)."""
    import torch

    from gdmcf_torch.models.registry import build_model

    model = build_model(cfg, n_user, n_item, train_csr=train_csr,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    return params_from_state_dict(_load_state_dict(path),
                                  dict(model.named_parameters()))


def main(argv=None):
    """Import a reference checkpoint and write it as a port checkpoint of
    step 0 with a fresh optimizer state (``train/checkpoint.py``)."""
    import argparse
    import sys

    import torch

    from gdmcf_torch.config import parse_args
    from gdmcf_torch.data.loader import data_load_dir
    from gdmcf_torch.train.checkpoint import Checkpointer
    from gdmcf_torch.train.trainer import Trainer

    args = argv if argv is not None else sys.argv[1:]
    conv = argparse.ArgumentParser(add_help=False)
    conv.add_argument("checkpoint", help=".pth / state_dict / .npz")
    conv.add_argument("--out", required=True, help="port checkpoint dir")
    ns, rest = conv.parse_known_args(args)
    cfg = parse_args(rest)

    train, _, _, n_user, n_item = data_load_dir(cfg.data_path)
    params = import_reference_checkpoint(ns.checkpoint, cfg, n_user, n_item,
                                         train_csr=train)
    trainer = Trainer(cfg, n_user, n_item, train_csr=train)
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            p.copy_(params[name])
    # after the copy: the masters of bfloat16-stored tensors start from
    # the imported values
    state = trainer.init_state()
    ckpt = Checkpointer(ns.out)
    ckpt.save(state)
    ckpt.close()
    print(f"imported {ns.checkpoint} -> {ns.out} "
          f"(step 0, fresh optimizer state)")


if __name__ == "__main__":
    main()
