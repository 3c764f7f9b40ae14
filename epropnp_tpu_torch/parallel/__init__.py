"""Data parallelism and host batch pipelines of the PyTorch port, the
counterpart of ``epropnp_tpu/parallel``: ``torch.distributed`` for the
device mesh and its ``pmean`` (``mesh``), the per-rank sampler
(``sampler``), and threaded producers with device prefetch
(``prefetch``)."""
