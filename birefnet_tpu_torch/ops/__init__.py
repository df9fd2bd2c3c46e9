"""Layers, window machinery, resizes and attention on torch tensors."""
