"""yaml config helpers (port of ``sparsebit_tpu/utils/yaml_utils.py``;
reference: sparsebit/utils/yaml_utils.py:4-24)."""


def _parse_config(cfg_file, default_cfg):
    """default_cfg merged with a dict or a yaml file (None: the defaults),
    frozen."""
    cfg = default_cfg.clone()
    if cfg_file is not None:
        if isinstance(cfg_file, dict):
            cfg.merge_from_dict(cfg_file)
        else:
            cfg.merge_from_file(cfg_file)
    cfg.freeze()
    return cfg


def update_config(config, args_list):
    """Mutate a (possibly frozen) config with a flat [k, v, k, v, ...]
    list."""
    config.defrost()
    config.merge_from_list(list(args_list))
    config.freeze()
    return config
