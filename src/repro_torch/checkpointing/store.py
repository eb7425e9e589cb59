"""Checkpointing with manifest + atomic commit + async writer.

Layout:
    <dir>/step_<N>/
        manifest.json      {step, leaf paths, shapes, dtypes}
        leaf_<i>.npy       one file per tree leaf
    <dir>/LATEST           atomic pointer (written last -> crash-consistent)

Fault-tolerance contract:
  * a checkpoint is visible only after LATEST is atomically renamed;
  * restore() reads LATEST, so a crash mid-write falls back to the previous
    complete checkpoint (checkpoint/restart).

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors, numpy arrays or Python scalars (a model's flat ``state_dict`` is
one dict; a training state is ``(params, AdamWState)``).  The walker
flattens it as JAX's tree utilities do: a plain dict in sorted key order,
an ``OrderedDict`` in insertion order, a NamedTuple's fields in order,
``None`` as an empty subtree, leaf paths in ``keystr`` form
(``['a'][0]``, ``[1].mu['w']``).  The manifest, the leaf files and the
pointer have the JAX package's format, so a checkpoint written by either
package restores in the other.  A bf16 leaf is written as the JAX package
writes it: its 2-byte words in a ``<V2`` ``.npy`` (numpy has no bf16),
manifest dtype ``"bfloat16"``; it is restored by viewing those words as
``torch.bfloat16``.  Re-placing a checkpoint onto other shardings
(``elastic_reshard``) is not part of this module.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from collections import OrderedDict
from typing import Any

import numpy as np
import torch


BF16 = "bfloat16"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> list[tuple[str, Any]] | None:
    """(path suffix, child) pairs of a container node, None for a leaf."""
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, OrderedDict):
        return [(f"[{k!r}]", v) for k, v in node.items()]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if type(node) in (list, tuple):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of ``tree`` in flattening order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pl for suffix, child in kids
            for pl in _flatten(child, prefix + suffix)]


def _unflatten(like, leaves) -> Any:
    """``like`` with its leaves replaced, in order, from the iterator."""
    if like is None:
        return None
    if isinstance(like, dict):
        keys = list(like) if isinstance(like, OrderedDict) else sorted(like)
        vals = {k: _unflatten(like[k], leaves) for k in keys}
        return type(like)((k, vals[k]) for k in like)
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if type(like) in (list, tuple):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(a numpy copy of the leaf that no later in-place update can reach,
    its manifest dtype); a bf16 tensor's copy holds its 2-byte words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _write_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, except that bf16 words get the header the JAX package
    writes for them (``descr '<V2'``)."""
    if dtype != BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.data)


def save(ckpt_dir: str, step: int, tree: Any, *, blocking: bool = True):
    """Write a checkpoint; returns a join() handle when blocking=False."""
    flat = _flatten(tree)
    paths = [p for p, _ in flat]
    host_leaves = [_to_host(l) for _, l in flat]  # device -> host copy now
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")

    def _write():
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, (p, (arr, dtype)) in enumerate(zip(paths, host_leaves)):
            _write_leaf(os.path.join(tmp, f"leaf_{i}.npy"), arr, dtype)
            manifest["leaves"].append(
                {"path": p, "file": f"leaf_{i}.npy",
                 "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # atomic pointer flip: LATEST names the only complete checkpoint
        ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
        with open(ptr_tmp, "w") as f:
            f.write(str(step))
        os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    """Step named by LATEST (None = no complete checkpoint)."""
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        return int(f.read().strip())


def _restore_leaf(arr: np.ndarray, dtype: str, leaf, path: str):
    """``arr`` (saved as manifest ``dtype``) shaped, typed and placed as
    ``leaf``: a tensor lands on the leaf's device with its dtype, a Python
    scalar comes back as one.  bf16 words become a bf16 tensor first."""
    shape = tuple(np.shape(leaf))
    if tuple(arr.shape) != shape:
        raise ValueError(f"leaf {path}: shape {arr.shape} != {shape}")
    if dtype == BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        if isinstance(leaf, torch.Tensor):
            return t.to(device=leaf.device, dtype=leaf.dtype)
        arr = t.to(torch.float32).numpy()
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    if not hasattr(leaf, "shape"):  # python scalar leaf
        return arr.astype(np.asarray(leaf).dtype).item()
    return arr.astype(leaf.dtype)


def restore(ckpt_dir: str, like: Any,
            step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of `like` (a tree of tensors, arrays or
    scalars).  Each leaf takes the dtype and, for a tensor, the device of
    the matching leaf of `like`.  Returns (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(like)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, expected "
            f"{len(flat)} — structure mismatch")
    out = [_restore_leaf(np.load(os.path.join(d, meta["file"])),
                         meta["dtype"], leaf, meta["path"])
           for (_, leaf), meta in zip(flat, manifest["leaves"])]
    return _unflatten(like, iter(out)), step
