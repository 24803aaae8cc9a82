"""Layers, LightGCN propagation, backbones and the registry."""
