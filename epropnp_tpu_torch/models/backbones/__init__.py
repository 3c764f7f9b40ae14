"""Backbones of the PyTorch port."""
