"""Config system: YAML option trees deep-merged with CLI overrides (port of
``core/config.py``).

Precedence is CLI non-None > YAML > hardcoded defaults, with a recursive
dict merge that skips ``None`` leaves; a YAML file may name a ``base:`` file
(relative to its own directory) whose tree it is merged onto.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Mapping, MutableMapping

import yaml


def update_values(dict_from: Mapping, dict_to: MutableMapping) -> MutableMapping:
    """Recursively copy non-None leaves of ``dict_from`` into ``dict_to``."""
    for key, value in dict_from.items():
        if isinstance(value, dict):
            if key not in dict_to or not isinstance(dict_to.get(key), dict):
                dict_to[key] = {}
            update_values(value, dict_to[key])
        elif value is not None:
            dict_to[key] = value
    return dict_to


def merge_dict(a: Any, b: Any) -> Any:
    """Pure merge: values of ``b`` win unless None (reference
    ``utils.py:14-21``)."""
    if isinstance(a, dict) and isinstance(b, dict):
        d = dict(a)
        d.update({k: merge_dict(a.get(k, None), b[k]) for k in b})
        return d
    if isinstance(a, list) and isinstance(b, list):
        return b
    return a if b is None else b


def str2bool(v):
    """CLI boolean parser (reference ``utils.py:49-59``)."""
    if v is None or isinstance(v, bool):
        return v
    if isinstance(v, str):
        if v.lower() in ("yes", "true", "t", "y", "1"):
            return True
        if v.lower() in ("no", "false", "f", "n", "0"):
            return False
    raise ValueError("Boolean value expected, got %r" % (v,))


def load_yaml(path: str) -> dict:
    with open(path, "r") as handle:
        return yaml.safe_load(handle)


def load_options_file(path: str) -> dict:
    """Load a YAML option tree, resolving ``base:`` includes recursively."""
    tree = load_yaml(path)
    base_name = tree.pop("base", None)
    if base_name is None:
        return tree
    base_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                             base_name)
    options = load_options_file(base_path)
    update_values(tree, options)
    return options


def resolve_options(defaults: dict, yaml_path: str | None = None,
                    cli_overrides: dict | None = None) -> dict:
    """defaults <- yaml <- cli(non-None), returning a fresh dict."""
    options = copy.deepcopy(defaults)
    if yaml_path:
        update_values(load_options_file(yaml_path), options)
    if cli_overrides:
        update_values(cli_overrides, options)
    return options


def options_subdir(params: Mapping, keys=("maxlength", "minwcount", "nlp", "pad",
                                          "trainsplit")) -> str:
    """The processed-dir name of the reference (``vqa_processed.py:212-215``):
    ``nans,2000_maxlength,26_..._trainsplit,train``."""
    sub = "nans," + str(params["nans"])
    for key in keys:
        sub += "_" + key + "," + str(params[key])
    return sub


def save_options(options: Mapping, run_dir: str,
                 name: str = "options.yaml") -> str:
    """Store the resolved options in the run dir (provenance)."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, name)
    with open(path, "w") as handle:
        yaml.safe_dump(_plain(options), handle, default_flow_style=False)
    return path


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj
