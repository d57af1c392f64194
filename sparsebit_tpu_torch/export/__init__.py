"""Export of the graph regime (port of ``sparsebit_tpu/export``): a
``torch.export`` program in place of the JAX package's StableHLO one,
with the same quant-metadata sidecar (``torch_export``)."""
