"""Typed-config base machinery.

TPU-native analogue of the reference ``runtime/config_utils.py``
(``DeepSpeedConfigModel``): a lightweight, dependency-free pydantic-style base
that reads a dict, applies declared field types/defaults, supports deprecated
aliases, and rejects unknown keys (with a warning, matching the reference's
lenient mode).
"""

import copy
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger


class ConfigError(Exception):
    pass


@dataclass
class DSConfigModel:
    """Base for all typed sub-configs.

    Subclasses declare dataclass fields; ``from_dict`` maps JSON keys onto
    them, honoring per-field ``metadata={"alias": "old_name"}`` deprecations.
    """

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]] = None, strict: bool = False):
        d = copy.copy(d) or {}
        if not isinstance(d, dict):
            raise ConfigError(f"{cls.__name__} expects a dict config, got {type(d)}")
        kwargs = {}
        known = {}
        for f in fields(cls):
            known[f.name] = f
            alias = f.metadata.get("alias")
            if alias and alias in d and f.name not in d:
                logger.warning(f"Config param '{alias}' is deprecated, use '{f.name}' instead")
                d[f.name] = d.pop(alias)
        for key, value in d.items():
            if key in known:
                f = known[key]
                sub = f.metadata.get("submodel")
                if sub is not None and isinstance(value, dict):
                    value = sub.from_dict(value, strict=strict)
                kwargs[key] = value
            else:
                msg = f"Unknown config key '{key}' for {cls.__name__}"
                if strict:
                    raise ConfigError(msg)
                logger.warning(msg)
        obj = cls(**kwargs)
        obj._validate()
        return obj

    def _validate(self):
        """Subclasses override for cross-field validation."""

    def to_dict(self):
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, DSConfigModel):
                v = v.to_dict()
            out[f.name] = v
        return out

    def __post_init__(self):
        # Instantiate default submodels declared as None
        for f in fields(self):
            sub = f.metadata.get("submodel")
            v = getattr(self, f.name)
            if sub is not None and v is None:
                setattr(self, f.name, sub.from_dict({}))
            elif sub is not None and isinstance(v, dict):
                setattr(self, f.name, sub.from_dict(v))


def submodel(model_cls, **kw):
    """Declare a nested typed sub-config field."""
    return field(default=None, metadata={"submodel": model_cls, **kw.pop("metadata", {})}, **kw)


def get_scalar_param(param_dict, param_name, param_default_value):
    """Reference runtime/config_utils.py get_scalar_param equivalent."""
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys in the user JSON (reference config_utils.py)."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ConfigError(f"Duplicate keys in DeepSpeed config: {keys}")
    return d
