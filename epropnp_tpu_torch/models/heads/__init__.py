"""Heads of the PyTorch port."""
