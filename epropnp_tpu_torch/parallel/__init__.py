"""Host batch pipelines of the PyTorch port (the single-device part of
``epropnp_tpu/parallel``; the mesh and the host shard sampler are not
ported)."""
