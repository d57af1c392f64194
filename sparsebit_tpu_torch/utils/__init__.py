"""Config helpers of the port (port of ``sparsebit_tpu/utils``: the config
tree and the yaml helpers)."""

from sparsebit_tpu_torch.utils.config import CfgNode  # noqa: F401
from sparsebit_tpu_torch.utils.yaml_utils import (  # noqa: F401
    _parse_config,
    update_config,
)
