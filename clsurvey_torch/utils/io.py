"""Checkpoint / result-dict IO, in the JAX package's on-disk format.

Counterpart of ``clsurvey_tpu/utils/io.py``: the same filenames and dict
shapes, written as pickles of plain Python / numpy objects (tensors are
turned into numpy arrays first), so a file written by either package loads
in the other. :func:`load` also reads ``torch.save`` zip files. Writes are
atomic (tmp + rename) so resume files are never torn.

Under a process group (``parallel/mesh.py``) :func:`save`,
:func:`save_compat`, :func:`save_json` and :func:`exists` are collective:
every rank calls them at the same program points. The writer (rank 0)
writes and every rank then passes a barrier, so the file a rank reads next
exists; :func:`exists` is the writer's answer on every rank, so no rank
sees a file the writer wrote after it looked. ``WRITES`` counts this
process's writes (the other ranks' stays 0)."""

from __future__ import annotations

import json
import os
import pickle
import tempfile
from typing import Any

import torch

from clsurvey_torch.parallel import mesh as mesh_lib

WRITES = {"files": 0}


def _leaf_to_host(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16
            x = x.float()
        return x.cpu().numpy()
    return x


def to_host(tree: Any) -> Any:
    """Tensors (on any device) -> numpy arrays, through dicts, lists and
    tuples; every other leaf is kept as it is."""
    if isinstance(tree, dict):
        return type(tree)((k, to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(to_host(v) for v in tree)
    return _leaf_to_host(tree)


def _atomic_write(path: str, writer) -> str:
    """Write via mkstemp + os.replace so readers never see a torn file; on
    the writer alone, then a barrier on every rank."""
    if mesh_lib.is_writer():
        _write_file(path, writer)
    mesh_lib.barrier()
    return path


def _write_file(path: str, writer) -> None:
    WRITES["files"] += 1
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            writer(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save(obj: Any, path: str) -> str:
    return _atomic_write(path, lambda f: pickle.dump(
        to_host(obj), f, protocol=pickle.HIGHEST_PROTOCOL))


def save_compat(obj: Any, path: str) -> str:
    """Write a reference-pipeline-compatible artifact in ``torch.save``
    format: the reference's postprocessing loads eval result dicts and
    hyperparams.pth.tar with ``torch.load``, which cannot read plain
    pickles (ref:src/framework/eval.py:176-185, framework_train.py:58-64)."""
    return _atomic_write(path, lambda f: torch.save(to_host(obj), f))


def save_json(obj: Any, path: str) -> str:
    """``obj`` as JSON text (the engine's ``error_history.json``)."""
    return _atomic_write(path, lambda f: f.write(json.dumps(obj).encode()))


def load(path: str) -> Any:
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head[:2] == b"PK":  # torch.save zip container
            return torch.load(f, map_location="cpu", weights_only=False)
        return pickle.load(f)


def exists(path: str) -> bool:
    return mesh_lib.agree(os.path.isfile(path) if mesh_lib.is_writer()
                          else False)

