"""Configuration of nerve_tpu_torch (counterpart of ``nerve_tpu.config``).

The defaults are the dataclasses' own (``config.schema``, the values of the
JAX package's ``default.yaml``), so loading them needs no file and no YAML
parser. ``load_config(path)`` reads a JSON file, or a YAML file with PyYAML,
which is imported only then.
"""

from __future__ import annotations

import json
from typing import Optional

from nerve_tpu_torch.config.schema import (  # noqa: F401
    CheckpointConfig,
    Config,
    LossConfig,
    ModelConfig,
    TrainingConfig,
    apply_overrides,
    config_from_dict,
    config_to_dict,
)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """The default Config, or one read from ``path`` (``.json``, else YAML),
    with dotted-path ``overrides`` such as ``{"training.batch_size": 8}``."""
    data = {}
    if path is not None:
        with open(path) as f:
            if path.endswith(".json"):
                data = json.load(f)
            else:
                import yaml

                data = yaml.safe_load(f) or {}
    cfg = config_from_dict(data)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg
