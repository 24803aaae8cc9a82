"""Trainer (the serving slice: model, diffusion, eval step)."""
