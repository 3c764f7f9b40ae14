"""Demos of the PyTorch port."""
