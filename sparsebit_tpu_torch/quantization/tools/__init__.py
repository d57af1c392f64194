"""Calibration tools of the graph regime (port of
``sparsebit_tpu/quantization/tools``): the reference-counted activation
store and the layerwise calibration runner; ``fixture`` holds the CNN
accuracy fixture. The error profiler and the QAT helpers come with the
next slice."""

from sparsebit_tpu_torch.quantization.tools.graph_wrapper import (  # noqa: F401
    SharedData,
)
from sparsebit_tpu_torch.quantization.tools.calibration import (  # noqa: F401
    CalibrationRunner,
)
