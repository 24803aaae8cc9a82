"""The dispatch channel: the main rank's serving ops, in one order, to every
rank of a world.

A recommender on a (dp, mp) mesh runs each dispatch on every rank: the
eval step's sharded lookup, its mp top-k and the dp gather of the ids are
collectives. Only the main rank takes requests, so it tells the others what
to run. Each op is a broadcast over the world group from rank 0: first a
fixed-size header, then the op's payload.

  header   int64 [op, rows, step, length]
  DISPATCH rows: the request's real rows; payload the padded user ids
           [serve_batch] and their per-row exclude flags [serve_batch]
           (one int64 tensor of 2 x serve_batch)
  RELOAD   step: the checkpoint step (-1: the newest); length: the bytes
           of the directory's UTF-8 path, the payload
  HEARTBEAT no payload: keeps an idle follower's broadcast inside the
           process group's timeout
  STOP     no payload: every rank leaves its loop

``agree`` is the one other collective of the channel: a reload swaps only
when every rank has read its blocks, and a stop returns once every rank
has seen it.

Broadcasts on one group complete in the order they are issued, so every
rank sees the ops in the main rank's order; the main rank issues them from
one thread (the recommender's dispatch lock, and under HTTP the
coalescer's dispatcher thread). Under gloo the tensors travel on the host,
under nccl on the rank's card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

DISPATCH, RELOAD, HEARTBEAT, STOP = 1, 2, 3, 4
SRC = 0


class Op(NamedTuple):
    code: int
    rows: int = 0                       # DISPATCH: the real rows
    ids: Optional[np.ndarray] = None    # DISPATCH: padded user ids
    exclude: Optional[np.ndarray] = None  # DISPATCH: per-row flags
    step: Optional[int] = None          # RELOAD
    directory: Optional[str] = None     # RELOAD


class Channel:
    """Rank 0 ``send``s, every other rank ``recv``s, op for op."""

    def __init__(self, serve_batch: int):
        from gdmcf_torch.parallel.multihost import _wire_device

        self.serve_batch = serve_batch
        self.device = _wire_device()
        self.is_source = dist.get_rank() == SRC

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.device)
        dist.broadcast(t, src=SRC)
        return t.cpu()

    def send(self, op: Op) -> None:
        if not self.is_source:
            raise RuntimeError("only the main rank sends on the channel")
        path = (op.directory or "").encode()
        step = -1 if op.step is None else int(op.step)
        self._bcast(torch.tensor([op.code, op.rows, step, len(path)],
                                 dtype=torch.int64))
        if op.code == DISPATCH:
            b = self.serve_batch
            if len(op.ids) != b or len(op.exclude) != b:
                raise ValueError(f"a dispatch carries {b} padded rows")
            self._bcast(torch.from_numpy(np.concatenate(
                [np.asarray(op.ids, np.int64),
                 np.asarray(op.exclude, np.int64)])))
        elif op.code == RELOAD and path:
            self._bcast(torch.frombuffer(bytearray(path), dtype=torch.uint8))

    def agree(self, ok: bool) -> bool:
        """True when every rank says ``ok`` (an all-reduce over the world,
        on every rank at the same point of the op order)."""
        flag = torch.tensor([1 if ok else 0], dtype=torch.int64,
                            device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    def recv(self) -> Op:
        """The next op (blocks; raises once the process group's timeout
        passes with no op, or when the main rank is gone)."""
        code, rows, step, length = self._bcast(
            torch.zeros(4, dtype=torch.int64)).tolist()
        if code == DISPATCH:
            b = self.serve_batch
            payload = self._bcast(torch.zeros(2 * b, dtype=torch.int64))
            return Op(DISPATCH, rows, ids=payload[:b].numpy(),
                      exclude=payload[b:].numpy().astype(bool))
        if code == RELOAD:
            raw = (self._bcast(torch.zeros(length, dtype=torch.uint8))
                   if length else torch.zeros(0, dtype=torch.uint8))
            return Op(RELOAD, step=None if step < 0 else step,
                      directory=bytes(raw.numpy()).decode() or None)
        if code in (HEARTBEAT, STOP):
            return Op(code)
        raise RuntimeError(f"unknown channel op {code}")
