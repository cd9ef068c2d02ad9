"""Read the JAX package's Orbax checkpoints without Orbax.

Counterpart of ``clsurvey_tpu/utils/orbax_io.py``, read side only: the JAX
engine writes its epoch resume trees to an Orbax PyTree checkpoint
directory (``epoch.pth.tar.orbax``) where orbax is importable, and the
port resumes from it. Orbax imports jax, so this module reads the
directory with tensorstore, imported inside :func:`load`.

The layout, as ``orbax.checkpoint.PyTreeCheckpointer().save`` writes it:
``_METADATA`` is JSON whose ``tree_metadata`` has one entry per leaf, with
the leaf's key path (``key_metadata``: each key with its ``key_type``, 1
for a sequence index, 2 for a dict key) and a ``value_metadata`` whose
``value_type`` is ``np.ndarray`` / ``jax.Array`` (an array), ``scalar`` (a
Python number, stored as a 0-d array), ``string`` (kept in
``_strings.json``) or an empty value (``None``, ``Dict``, ``List``,
``Tuple``: nothing stored). Each array is a zarr array at the dot-joined
key path, in an OCDBT key-value store at the directory's root (or a
directory of its own without OCDBT). :func:`load` rebuilds the tree as
nested dicts and lists, with numpy arrays and Python scalars at the
leaves: what ``clsurvey_tpu.utils.orbax_io.load`` returns for the same
directory."""

from __future__ import annotations

import json
import os
from typing import Any

_SEQUENCE_KEY = 1
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": list}


def available() -> bool:
    """Whether :func:`load` can read a checkpoint here (tensorstore)."""
    try:
        import tensorstore  # noqa: F401

        return True
    except ImportError:
        return False


def _read_array(ts, root: str, name: str, meta: dict):
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    if meta.get("use_ocdbt", True):
        kvstore = {"driver": "ocdbt", "base": f"file://{root}",
                   "path": name}
    else:
        kvstore = {"driver": "file", "path": os.path.join(root, name)}
    return ts.open({"driver": driver, "kvstore": kvstore},
                   open=True).result().read().result()


def _insert(tree: dict, keys: list, value: Any) -> None:
    """Put ``value`` at ``keys`` (``(name, is_index)`` pairs) in ``tree``,
    a dict of containers; a sequence is kept as an index -> value dict
    until :func:`_to_lists`."""
    node = tree
    for (key, _), (_, next_is_index) in zip(keys, keys[1:]):
        node = node.setdefault(key, {})
        if next_is_index:
            node.setdefault("__sequence__", True)
    node[keys[-1][0]] = value


def _to_lists(node):
    if not isinstance(node, dict):
        return node
    if node.pop("__sequence__", False):
        return [_to_lists(node[k]) for k in sorted(node, key=int)]
    return {k: _to_lists(v) for k, v in node.items()}


def load(path: str) -> Any:
    """The tree of the Orbax PyTree checkpoint directory ``path``."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise RuntimeError(
            f"{path} is an Orbax checkpoint directory; clsurvey_torch reads "
            f"it with tensorstore, which is not importable here (install "
            f"tensorstore, or delete the checkpoint to restart the "
            f"task)") from e
    root = os.path.abspath(path)
    with open(os.path.join(root, "_METADATA")) as f:
        meta = json.load(f)
    strings_path = os.path.join(root, "_strings.json")
    strings = {}
    if os.path.isfile(strings_path):
        with open(strings_path) as f:
            strings = json.load(f)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        # a sequence's indices arrive as strings; they stay dict keys
        # until the sequence becomes a list
        keys = [(k["key"], k["key_type"] == _SEQUENCE_KEY)
                for k in entry["key_metadata"]]
        kind = entry["value_metadata"]["value_type"]
        name = ".".join(k for k, _ in keys)
        if kind in _EMPTY:
            value = _EMPTY[kind]()
        elif kind == "string":
            value = strings[name]
        elif kind == "scalar":
            value = _read_array(ts, root, name, meta).item()
        else:
            value = _read_array(ts, root, name, meta)
        _insert(tree, keys, value)
    return _to_lists(tree)
