"""Observer registry (port of
``sparsebit_tpu/quantization/observers/__init__.py``; reference:
sparsebit/quantization/observers/__init__.py:4-21).

minmax, mse, percentile, moving_average, aciq and kl_histogram (whose
search runs on the data's device, ``kl_device``). As in the JAX package,
``kl_device`` is the search module, not an observer type of its own.
"""

OBSERVERS_MAP = {}


def register_observer(observer_cls):
    OBSERVERS_MAP[observer_cls.TYPE.lower()] = observer_cls
    return observer_cls


from sparsebit_tpu_torch.quantization.observers.base import (  # noqa: E402,F401
    DataCache,
    Observer,
)
from sparsebit_tpu_torch.quantization.observers import (  # noqa: E402,F401
    aciq,
    kl_histogram,
    minmax,
    moving_average,
    mse,
    percentile,
)


def build_observer(config, qdesc):
    observer_type = config.OBSERVER.TYPE.lower()
    assert observer_type in OBSERVERS_MAP, "no observer named {}".format(
        observer_type)
    return OBSERVERS_MAP[observer_type](config, qdesc)
