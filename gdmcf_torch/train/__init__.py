"""Trainer (train and eval steps, evaluate, fit), train state, checkpoints."""
