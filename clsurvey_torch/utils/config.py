"""Root-path configuration, compatible with the reference's ``config.init``.

The reference reads an INI file with section ``[DEFAULT]`` and keys
``test_results_root_path``, ``tr_results_root_path``, ``models_root_path``,
``ds_root_path``; ``./``-relative values are resolved against the source root
and the directories are auto-created (ref:src/utilities/utils.py:26-42,
ref:src/config.init:1-7).

We keep that file format so existing configs drop in, default everything
under the repo when no config file exists, and additionally allow overrides
via environment variables (``CLSURVEY_<KEY>``)."""

from __future__ import annotations

import configparser
import os
from dataclasses import dataclass, field
from pathlib import Path

_KEYS = (
    "test_results_root_path",
    "tr_results_root_path",
    "models_root_path",
    "ds_root_path",
)


@dataclass
class Config:
    test_results_root_path: str
    tr_results_root_path: str
    models_root_path: str
    ds_root_path: str
    source_root: str = field(default="")

    def __post_init__(self):
        for key in _KEYS:
            val = getattr(self, key)
            path = Path(val)
            if not path.is_absolute():
                path = Path(self.source_root or os.getcwd()) / val
            path = path.resolve()
            path.mkdir(parents=True, exist_ok=True)
            setattr(self, key, str(path))


_CACHED: Config | None = None


def default_root() -> str:
    return os.environ.get("CLSURVEY_ROOT", os.path.join(os.getcwd(), "clsurvey_runs"))


def load_config(config_path: str | None = None, refresh: bool = False) -> Config:
    """Load config.init if present; otherwise defaults under CLSURVEY_ROOT."""
    global _CACHED
    if _CACHED is not None and not refresh and config_path is None:
        return _CACHED

    candidates = []
    if config_path:
        if not os.path.isfile(config_path):
            # an explicitly passed path must not silently fall through to
            # env/cwd defaults — results would land in the wrong tree
            raise FileNotFoundError(f"config file missing: {config_path}")
        candidates.append(config_path)
    env_path = os.environ.get("CLSURVEY_CONFIG")
    if env_path:
        candidates.append(env_path)
    candidates.append(os.path.join(os.getcwd(), "config.init"))

    values = {}
    source_root = os.getcwd()
    for cand in candidates:
        if cand and os.path.isfile(cand):
            parser = configparser.ConfigParser()
            parser.read(cand)
            section = parser["DEFAULT"]
            for key in _KEYS:
                if key in section:
                    values[key] = section[key]
            source_root = os.path.dirname(os.path.abspath(cand))
            break

    root = default_root()
    defaults = {
        "test_results_root_path": os.path.join(root, "results", "test"),
        "tr_results_root_path": os.path.join(root, "results", "train"),
        "models_root_path": os.path.join(root, "models"),
        "ds_root_path": os.path.join(root, "datasets"),
    }
    for key in _KEYS:
        env_override = os.environ.get("CLSURVEY_" + key.upper())
        if env_override:
            values[key] = env_override
        values.setdefault(key, defaults[key])

    cfg = Config(source_root=source_root, **values)
    if config_path is None:
        _CACHED = cfg
    return cfg


def set_config(cfg: Config) -> None:
    global _CACHED
    _CACHED = cfg
