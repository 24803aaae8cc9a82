"""Diffusion schedules and the discrete-class engine."""
