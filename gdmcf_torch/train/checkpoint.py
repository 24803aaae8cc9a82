"""Checkpoint and resume of the whole train state.

Port of the JAX package's ``train/checkpoint.py`` on ``torch.save`` and
``torch.load(weights_only=True)``. A checkpoint holds the complete
``TrainState``: parameters, both AdamW moments and their step count, the
float32 masters of the bfloat16-stored tensors (an empty ``master`` group
in a float32 run), the Lt ring, the step, and the step generator's
``get_state()``, so a restored run continues bit for bit.

Layout: one file per step, ``<directory>/ckpt_<step>.pt``, written under a
temporary name and committed by ``os.replace``: a crash mid-write never
leaves a file that ``latest_step`` or ``restore`` can see. The newest
``max_to_keep`` files are kept. ``train_meta.json`` is the sidecar of the
``extra`` dict, written only after its checkpoint commits.

On a (dp, mp) mesh the format is the same: ``save`` is collective (the
main rank's mp group gathers the whole of each sharded tensor, and only the
main rank copies the state to the host and writes), and
``restore`` is collective too (every rank reads the whole tensors and
keeps its blocks); ``load_params`` (a server's read) returns a rank's
blocks without a collective. A checkpoint of a mesh run restores into a
single-device run and the other way round. The directory must be visible
to every rank (one host, or a shared filesystem).
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Dict, Optional

import torch

from gdmcf_torch.parallel.multihost import is_main_process, sync_hosts
from gdmcf_torch.parallel.sharding import full_tensor, local_block, shard_of
from gdmcf_torch.train.state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that later in-place updates of ``t`` cannot reach."""
    return t.detach().to("cpu", copy=True)


def _payload(state: TrainState, writer: bool = True) -> Optional[Dict]:
    """The state as a dict of host tensors and ints (what ``save`` writes),
    a sharded tensor and its moments whole. On a mesh the gather of a
    sharded tensor is collective over the main rank's mp group; a rank that
    does not write takes its part in that gather, keeps nothing, and gets
    None."""
    import torch.distributed as dist

    def whole(t: torch.Tensor, shard) -> Optional[torch.Tensor]:
        if shard is not None:
            if 0 not in dist.get_process_group_ranks(shard.group):
                return None   # not the main rank's mp group
            t = full_tensor(t, shard)
        return _host(t) if writer else None

    opt = state.opt_state
    shards = {k: shard_of(p) for k, p in state.params.items()}
    tensors = {key: {k: whole(m, shards[k]) for k, m in part.items()}
               for key, part in _groups(state)}
    if not writer:
        return None
    return dict(tensors, step=int(state.step), count=_host(opt.count),
                lt_history=_host(state.lt.history),
                lt_count=_host(state.lt.count),
                generator=state.generator.get_state())


def _groups(state: TrainState):
    """(key, {name: tensor}) of every per-parameter group of the state; a
    master is sharded as its parameter is."""
    opt = state.opt_state
    return (("params", state.params), ("mu", opt.mu), ("nu", opt.nu),
            ("master", opt.master or {}))


def _copy_into(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(
            f"checkpoint tensor {name} is {src.dtype} {tuple(src.shape)}, the "
            f"template's is {dst.dtype} {tuple(dst.shape)}: it was saved "
            "under a different geometry or config")
    with torch.no_grad():
        dst.copy_(src)


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.writer = is_main_process()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._pending_extra: Optional[dict] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self):
        """Committed steps, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            m = _NAME.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: Optional[int] = None,
             extra: Optional[dict] = None, block: bool = True) -> None:
        """``extra``: small JSON-serializable training metadata (best metric
        and epoch) for the sidecar, so a resume does not reset model
        selection.

        ``block=False`` returns once the tensors are copied to host memory
        and writes the file on a background thread; the next ``save`` or
        :meth:`wait` joins it. The sidecar is written only after its
        checkpoint commits (deferred to that join when non-blocking): it
        must never point at a best checkpoint that did not land."""
        step = int(state.step) if step is None else int(step)
        # commit any earlier background save AND flush its deferred sidecar
        # first: a blocking save would otherwise drop that sidecar
        self.wait()
        payload = _payload(state, self.writer)
        if self.writer:
            payload["step"] = step
            self._pending_extra = extra
            self._thread = threading.Thread(target=self._write,
                                            args=(step, payload),
                                            daemon=True)
            self._thread.start()
        if block:
            self.wait()

    def _write(self, step: int, payload: Dict) -> None:
        try:
            final = self._path(step)
            tmp = f"{final}.tmp-{os.getpid()}"
            torch.save(payload, tmp)
            os.replace(tmp, final)
            for old in self.steps()[:-self.max_to_keep]:
                if old != step:
                    os.remove(self._path(old))
        except Exception as e:   # re-raised by wait() on the caller
            self._error = e

    def wait(self) -> None:
        """Block until a background save has committed, then write its
        deferred ``extra`` sidecar. Raises what the background write
        raised. On a mesh, every rank returns once the main rank has
        committed (collective)."""
        try:
            self._join()
        finally:
            sync_hosts("checkpoint")

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            self._pending_extra = None
            raise err
        extra, self._pending_extra = self._pending_extra, None
        if extra is not None:
            path = os.path.join(self.directory, "train_meta.json")
            with open(f"{path}.tmp", "w") as fh:
                json.dump(extra, fh)
            os.replace(f"{path}.tmp", path)

    def load_extra(self) -> Optional[dict]:
        """The sidecar written by ``save(extra=...)`` (None if absent)."""
        path = os.path.join(self.directory, "train_meta.json")
        if not os.path.exists(path):
            return None
        with open(path) as fh:
            return json.load(fh)

    def restore(self, template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Copy the checkpoint into ``template`` in place, on the template's
        device: the parameters stay the live module's tensors, so the
        ``TrainState.params`` aliases and the model stay valid. Returns the
        template."""
        self.wait()   # on a mesh: the main rank's writes have committed
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        data = torch.load(self._path(step), map_location="cpu",
                          weights_only=True, mmap=True)
        opt = template.opt_state
        for key, live in _groups(template):
            # a checkpoint written before masters existed has no group:
            # it restores into a float32 run
            saved = data.get(key, {})
            if set(saved) != set(live):
                raise ValueError(
                    f"checkpoint {key} names {sorted(saved)} differ from "
                    f"the template's {sorted(live)}: it was saved under "
                    "another config (param_dtype, bf16_weights)")
            for name, t in live.items():
                src = saved[name]
                shard = shard_of(template.params[name])
                if shard is not None:   # a mesh rank keeps its block
                    if src.shape[shard.dim] != t.shape[shard.dim] * \
                            shard.count:
                        raise ValueError(
                            f"checkpoint tensor {key}.{name} is "
                            f"{src.dtype} {tuple(src.shape)}: it was saved "
                            "under a different geometry or config")
                    src = local_block(src, shard)
                _copy_into(t, src, f"{key}.{name}")
        _copy_into(opt.count, data["count"], "count")
        _copy_into(template.lt.history, data["lt_history"], "lt_history")
        _copy_into(template.lt.count, data["lt_count"], "lt_count")
        template.generator.set_state(data["generator"])
        template.step = int(data["step"])
        return template

    def load_params(self, step: Optional[int] = None,
                    shards: Optional[Dict[str, object]] = None):
        """(step, {name: parameter}) of a checkpoint, the parameters alone
        as host tensors mapped from the file (``mmap``): the moments,
        stored beside them, are never read. What a server reloads.

        ``shards``: {name: MeshShard or None} of a mesh rank's parameters
        (``shard_of`` of each); a sharded parameter comes back as this
        rank's block (a view of the mapped file, the placement ``restore``
        keeps), after a check that the whole tensor divides into the
        rank's blocks."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        data = torch.load(self._path(step), map_location="cpu",
                          weights_only=True, mmap=True)
        params = data["params"]
        for name, shard in (shards or {}).items():
            if shard is None or name not in params:
                continue
            src = params[name]
            if (src.ndim <= shard.dim
                    or src.shape[shard.dim] % shard.count):
                raise ValueError(
                    f"checkpoint tensor {name} is {src.dtype} "
                    f"{tuple(src.shape)}: it does not cut into {shard.count}"
                    f" blocks along dim {shard.dim} (saved under another "
                    "geometry or config)")
            params[name] = local_block(src, shard)
        return int(data["step"]), params

    def close(self) -> None:
        self.wait()   # a deferred sidecar must not die with the object
