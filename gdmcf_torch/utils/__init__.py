"""Utilities: structured metric logging."""
