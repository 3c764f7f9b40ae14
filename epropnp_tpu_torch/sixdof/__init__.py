"""6DoF suite of the PyTorch port (serving path)."""
