"""Utilities: structured metric logging and profiling hooks."""
