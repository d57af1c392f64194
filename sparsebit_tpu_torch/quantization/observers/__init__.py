"""Observer registry (port of
``sparsebit_tpu/quantization/observers/__init__.py``; reference:
sparsebit/quantization/observers/__init__.py:4-21).

Ported: minmax, mse, percentile and moving_average. The histogram
observers aciq, kl_histogram and kl_device (the on-device KL search that
kl_histogram uses) come with the calibration tools; until then
``build_observer`` raises NotImplementedError for them.
"""

OBSERVERS_MAP = {}
NOT_PORTED = ("aciq", "kl_histogram", "kl_device")


def register_observer(observer_cls):
    OBSERVERS_MAP[observer_cls.TYPE.lower()] = observer_cls
    return observer_cls


from sparsebit_tpu_torch.quantization.observers.base import (  # noqa: E402,F401
    DataCache,
    Observer,
)
from sparsebit_tpu_torch.quantization.observers import (  # noqa: E402,F401
    minmax,
    moving_average,
    mse,
    percentile,
)


def build_observer(config, qdesc):
    observer_type = config.OBSERVER.TYPE.lower()
    if observer_type in NOT_PORTED:
        raise NotImplementedError(
            "observer {!r} is not ported yet (aciq, kl_histogram and "
            "kl_device come with the calibration tools)".format(
                observer_type))
    assert observer_type in OBSERVERS_MAP, "no observer named {}".format(
        observer_type)
    return OBSERVERS_MAP[observer_type](config, qdesc)
