"""Shape ops (port of ``sparsebit_tpu/quantization/modules/shape.py``):
all unquantized. Shapes are static in the traced graph (the tracer folds
``x.shape`` into constants), so these stay float op-modules listed in
``PASSTHROUGH_MODULES``; no QModule wraps them."""
