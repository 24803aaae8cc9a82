"""Typed configuration: the port's own copy of the JAX package's ``config.py``.

Same flag names and YAML loading, so the recipes in ``configs/*.yaml`` load
unchanged (``-c file.yaml`` loads the preset, any explicitly passed flag
overrides it). Added: ``--device`` (default ``cuda``; see
``gdmcf_torch.resolve_device``). Fields this slice does not use are kept so
that every recipe and flag parses.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import yaml


def _as_int_list(name: str, value) -> List[int]:
    """Normalize a list flag: YAML lists ("[10, 20]"), bare comma lists
    ("10,20") and scalars ("1000" / 1000)."""
    if isinstance(value, str):
        value = yaml.safe_load(value)
        if isinstance(value, str):  # "10,20" parses as a plain string
            value = [v for v in value.split(",") if v.strip() != ""]
    if isinstance(value, (int, float)):
        value = [value]
    try:
        return [int(v) for v in value]
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"{name} must be an int list (e.g. [10, 20] or 10,20 or a "
            f"single int), got {value!r}") from e


@dataclass
class Config:
    # ---- data ----
    dataset: str = "yelp_clean"
    data_path: str = "./Datasets/yelp_clean/"

    # ---- optimization ----
    lr: float = 1e-4
    weight_decay: float = 0.0
    batch_size: int = 400
    random_seed: int = 1
    epochs: int = 1000

    # ---- evaluation ----
    topN: List[int] = field(default_factory=lambda: [10, 20, 50, 100])
    tst_w_val: bool = False

    # ---- runtime/logging ----
    cuda: bool = False  # accepted for recipe compatibility; see ``device``
    gpu: str = "0"      # accepted for recipe compatibility
    save_path: str = "./saved_models/"
    log_name: str = "log"
    round: int = 1
    out_name: str = "GDMCF"
    debug: bool = False

    # ---- model switches ----
    noise_type: int = 0        # 0 both channels, 1 drop continuous, 2 drop discrete
    gcnLayerNum: int = 2
    user_guided: int = 1
    time_type: str = "cat"
    dims: List[int] = field(default_factory=lambda: [1000])
    norm: bool = False
    emb_size: int = 10
    backbone: str = "DNNOneHotEmbeddingGCN"
    OneHotMatrix: int = 2      # 0 default, 1 block one-hot matrix, 2 class one-hot

    # ---- diffusion ----
    mean_type: str = "x0"      # x0 | eps
    steps: int = 100
    noise_schedule: str = "linear-var"  # linear | linear-var | cosine | binomial
    noise_scale: float = 0.1
    noise_min: float = 0.001
    noise_max: float = 0.01
    sampling_noise: bool = False
    sampling_steps: int = 25
    reweight: bool = True
    discrete: float = 0.9995   # epsilon of the 2-state transition matrix

    # ---- framework extras ----
    diffusion_variant: str = "discrete"   # discrete | legacy | ablation
    n_user_cap: Optional[int] = None
    # reproduce the reference's quirks (alpha_bar = ts / batch_size, ...)
    fidelity: bool = True
    symmetric_gcn: bool = False
    dropout: float = 0.5
    param_dtype: str = "float32"
    bf16_weights: tuple = ()
    # matmul precision: "bfloat16" = the fast default (TF32 on the GPU),
    # "float32" = full f32 products (TF32 off)
    compute_dtype: str = "bfloat16"
    opt_moment_dtype: str = "bfloat16"
    opt_impl: str = "auto"
    eval_every: int = 5
    early_stop_patience: int = 200
    history_num_per_term: int = 10
    beta_fixed: bool = True
    mesh_dp: int = 1
    mesh_mp: int = 1
    drop_last: bool = True
    shuffle: bool = True
    host_dense: bool = True
    debug_nans: bool = False
    rng_impl: str = "threefry2x32"
    train_steps_per_call: int = 8
    prefetch_batches: int = 2
    # host->device wire format: "packed" ships binary rows as bits
    wire_format: str = "packed"
    eval_batches_per_call: int = 8
    eval_replicated: bool = False
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    lr_total_steps: int = 0
    grad_clip_norm: float = 0.0
    ckpt_dir: Optional[str] = None
    resume: bool = False
    ckpt_every: int = 0
    # ---- port extras ----
    device: str = "cuda"

    def __post_init__(self):
        self.topN = _as_int_list("topN", self.topN)
        self.dims = _as_int_list("dims", self.dims)
        if self.mean_type not in ("x0", "eps"):
            raise ValueError(f"Unimplemented mean type {self.mean_type}")
        if self.time_type != "cat":
            raise ValueError(f"Unimplemented timestep embedding type {self.time_type}")
        if self.diffusion_variant not in ("discrete", "legacy", "ablation"):
            raise ValueError(f"unknown diffusion_variant {self.diffusion_variant}")
        if self.param_dtype not in ("float32", "bfloat16"):
            raise ValueError("param_dtype must be float32 or bfloat16")
        if isinstance(self.bf16_weights, str):
            self.bf16_weights = (self.bf16_weights,)
        else:
            self.bf16_weights = tuple(self.bf16_weights)
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError("compute_dtype must be bfloat16 or float32")
        if self.wire_format not in ("packed", "f32"):
            raise ValueError("wire_format must be packed or f32")
        if self.lr_schedule not in ("constant", "cosine", "linear"):
            raise ValueError("lr_schedule must be constant, cosine or linear")
        if self.OneHotMatrix == 1 and not self.drop_last:
            raise ValueError(
                "OneHotMatrix=1 sizes the model input as n_item + batch_size"
                " (reference main.py:198-206): a trailing partial batch "
                "cannot run through it; keep drop_last=true")
        if self.opt_moment_dtype not in ("bfloat16", "float32"):
            raise ValueError("opt_moment_dtype must be bfloat16 or float32")
        # opt_impl: every value but the JAX package's optimizer chain
        # selects the single-pass AdamW (train/state.py refuses that one).
        # The JAX package's mesh refusal stands, so a config valid in one
        # package is valid in the other (its words, but for the name of
        # the JAX optimizer library, which the port's sources do not
        # name); on a mesh "auto" (the JAX package's GSPMD-partitioned
        # chain) is the same kernel on each rank's own blocks here: AdamW
        # is elementwise
        if self.opt_impl in ("inline", "fused") and not self.fused_opt_eligible:
            raise ValueError(
                f"opt_impl={self.opt_impl!r} requires param_dtype=float32 "
                "and a single-device mesh (bf16 params need the JAX "
                "package's f32-master optimizer wrapper; meshes keep its "
                "GSPMD-partitioned optimizer chain); use opt_impl='auto' to "
                "fall back automatically")
        if self.device.split(":")[0] not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {self.device!r}")

    @property
    def fused_opt_eligible(self) -> bool:
        return (self.param_dtype == "float32"
                and self.mesh_dp * self.mesh_mp == 1)

    def out_dims(self, n_item: int) -> List[int]:
        """Reference main.py:198-206: out = dims + [n_item], in = reversed."""
        out = list(self.dims) + [n_item]
        if self.OneHotMatrix == 1:
            out = list(self.dims) + [n_item + self.batch_size]
        return out

    def in_dims(self, n_item: int) -> List[int]:
        return self.out_dims(n_item)[::-1]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_FIELD_TYPES = {f.name: f for f in dataclasses.fields(Config)}


def _coerce(name: str, value):
    """Coerce a YAML/CLI value to the dataclass field's type."""
    f = _FIELD_TYPES[name]
    if value is None or (isinstance(value, str)
                         and value.lower() in ("none", "null")):
        return None
    t = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", "")
    if "List" in t or "list" in t:
        return value  # parsed by __post_init__ (yaml list syntax)
    if "bool" in t:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "y")
        return bool(value)
    if "int" in t:
        return int(value)
    if "float" in t:
        return float(value)
    if t == "str":
        return str(value)
    return value


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[dict] = None) -> Config:
    """Build a Config from an optional YAML preset plus explicit overrides."""
    values: dict = {}
    if yaml_path:
        with open(yaml_path) as fh:
            loaded = yaml.safe_load(fh) or {}
        for k, v in loaded.items():
            if k not in _FIELD_TYPES:
                raise KeyError(f"Unknown config key {k!r} in {yaml_path}")
            values[k] = _coerce(k, v)
    if overrides:
        for k, v in overrides.items():
            if k not in _FIELD_TYPES:
                raise KeyError(f"Unknown config override {k!r}")
            values[k] = _coerce(k, v)
    return Config(**values)


def parse_args(argv: Optional[List[str]] = None) -> Config:
    """Every Config field is a ``--flag``; flags override the YAML preset."""
    parser = argparse.ArgumentParser(description="gdmcf_torch")
    parser.add_argument("-c", "--config", default=None, help="YAML config preset")
    for f in dataclasses.fields(Config):
        flag = f"--{f.name}"
        if f.type in ("bool", bool):
            parser.add_argument(flag, nargs="?", const=True, default=None,
                                type=str)
        elif f.name in ("dims", "topN"):
            parser.add_argument(flag, default=None, type=str,
                                help="YAML list, e.g. [1000]")
        else:
            parser.add_argument(flag, default=None, type=str)
    ns = parser.parse_args(argv)
    overrides = {k: v for k, v in vars(ns).items()
                 if k != "config" and v is not None}
    return load_config(ns.config, overrides)
