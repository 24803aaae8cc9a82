"""A rank's block of a batch sharded over dp.

On a mesh with dp > 1 each dp group trains on, or scores, a contiguous block
of every global batch. A ``RowBlock`` names that block. The trainer makes
one for each train step and each dp-sharded eval batch and passes it
explicitly to the engine (``training_losses`` / ``p_sample``'s ``block``),
so that the block's result is its rows of the single-device result on the
whole batch:

  * ``cut``: the trainer draws the whole batch's randomness from the
    generator every rank shares (``Diffusion.train_draws`` /
    ``p_sample_draws``, the model's ``dropout_draws``) and keeps this
    block's rows of each draw;
  * ``total``: the batch size the discrete channel divides by (the
    reference's ``ts / batch_size`` quirk);
  * ``gather``: the Lt ring's input is the whole batch's, in batch order;
  * ``max``: the degree gate normalizes by the whole batch's maximum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from gdmcf_torch.parallel.collectives import all_gather_list, all_reduce


class RowBlock(NamedTuple):
    lo: int          # first global row of this rank's block
    hi: int
    total: int       # global batch size
    group: object    # the dp process group, ordered by dp coordinate

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This block's rows of a [total, ...] tensor, as a copy (the
        whole draw is freed)."""
        return t[self.lo:self.hi].clone()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch's rows of a per-row tensor (no gradient)."""
        return torch.cat(all_gather_list(t.detach(), self.group), dim=0)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum over the whole batch of a block's 0-d maximum."""
        return all_reduce(t, self.group, op=dist.ReduceOp.MAX)
