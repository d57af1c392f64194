"""Tools of the graph regime (port of
``sparsebit_tpu/quantization/tools``): the reference-counted activation
store, the layerwise calibration runner, the quantization-error profiler
and the QAT step; ``fixture`` holds the accuracy fixtures."""

from sparsebit_tpu_torch.quantization.tools.graph_wrapper import (  # noqa: F401
    SharedData,
)
from sparsebit_tpu_torch.quantization.tools.calibration import (  # noqa: F401
    CalibrationRunner,
)
from sparsebit_tpu_torch.quantization.tools.errors_profiler import (  # noqa: F401
    QuantizationErrorProfiler,
)
from sparsebit_tpu_torch.quantization.tools.qat import (  # noqa: F401
    commit_qat_params,
    cross_entropy,
    init_qat_state,
    make_qat_step,
)
