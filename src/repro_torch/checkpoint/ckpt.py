"""Checkpointing: state -> step-numbered directory of .npz + json meta,
after ``repro/checkpoint/ckpt.py``, in the same format.

Leaves are saved as a flat npz keyed by the reference's tree paths
(``params/stack/[0]/ffn/wg``, ``opt/count``, ``step``), so a checkpoint
written by either package loads in the other.  ``tree_items`` flattens
like ``jax.tree_util.tree_flatten_with_path``: dict keys sorted, list
and tuple entries ``[i]``, NamedTuple fields in field order; an object
with a ``checkpoint_tree()`` method (the port's ``TrainState``, whose
pytree is the reference's ``TrainState``) stands for that tree, and an
iterator of ``(key, leaf)`` pairs in that order (a leaf stream, such as
a sharded state's gathered leaves) for the tree it walks.  Leaves are
torch tensors (on any device), numpy arrays or Python numbers.
Dtypes numpy lacks (bf16, fp8) are stored as same-width uint views and
read back through torch, not ``ml_dtypes``.

Crash atomicity (``write_staged``): a checkpoint becomes visible only
through the final ``os.rename`` of its staging dir; the payload files
and the staging dir are fsynced before it, the parent after it.  A crash
at any point leaves the previous checkpoint set intact plus an orphaned
``step_*.tmp`` dir (swept by the next save).  ``_crash_hook`` lets tests
kill the writer at each boundary.

Discovery (``intact_steps``) skips stray ``step_*`` entries and step
dirs missing ``meta.json`` or a payload, warning once per path.
Restoring fills the template's tensors in place, on their device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import warnings
from collections.abc import Iterator
from typing import Any, Callable, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "restore_train_state", "intact_steps", "tree_items",
           "flatten_with_paths", "fill_tree", "write_staged"]

_UINT_FOR_SIZE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_INT_FOR_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

#: torch dtypes numpy lacks, by the name ``ml_dtypes`` gives them (the
#: reference records ``str(arr.dtype)``)
_TORCH_EXOTIC = {torch.bfloat16: "bfloat16"}
for _name in ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz"):
    if hasattr(torch, _name):
        _TORCH_EXOTIC[getattr(torch, _name)] = _name
_EXOTIC_BY_NAME = {v: k for k, v in _TORCH_EXOTIC.items()}

_STEP_RE = re.compile(r"^step_(\d+)$")

#: once-per-path memory of discovery warnings
_WARNED_PATHS: set = set()


def _warn_once(path: str, message: str) -> None:
    if path in _WARNED_PATHS:
        return
    _WARNED_PATHS.add(path)
    warnings.warn(message, RuntimeWarning, stacklevel=3)


# ------------------------------------------------------------- tree walking
def _node(tree):
    return tree.checkpoint_tree() if hasattr(tree, "checkpoint_tree") else tree


def tree_items(tree, prefix: tuple = ()) -> list:
    """``[(key, leaf)]`` in ``jax.tree_util.tree_flatten_with_path`` order,
    ``key`` the ``/``-joined path."""
    tree = _node(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        children = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        children = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        children = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return [("/".join(prefix), tree)]
    return [item for name, child in children
            for item in tree_items(child, prefix + (name,))]


def _stored(leaf) -> tuple[np.ndarray, str]:
    """(host array in its storage dtype, true dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _TORCH_EXOTIC.get(t.dtype)
        if name is not None:  # same-width int view on the device, uint on the host
            arr = t.view(_INT_FOR_SIZE[t.element_size()]).cpu().numpy()
            return arr.view(_UINT_FOR_SIZE[arr.itemsize]), name
        arr = t.cpu().numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "biufc":  # exotic numpy dtypes -> uint view
        return arr.view(_UINT_FOR_SIZE[arr.dtype.itemsize]), str(arr.dtype)
    return arr, str(arr.dtype)


def flatten_with_paths(tree) -> tuple[dict, dict]:
    """Returns (key -> host array in its storage dtype, key -> dtype name);
    bf16/fp8 leaves are same-width uint views (the reference's format).
    ``tree`` may also be a leaf stream: an iterator of ``(key, leaf)`` in
    ``tree_items`` order, each leaf copied to the host before the next
    is asked for."""
    out, dtypes = {}, {}
    for key, leaf in tree if isinstance(tree, Iterator) else tree_items(tree):
        out[key], dtypes[key] = _stored(leaf)
        del leaf
    return out, dtypes


def loaded_array(raw: np.ndarray, dtype: str):
    """A stored array viewed as its true dtype: numpy for numpy's dtypes, a
    CPU torch tensor for the ones numpy lacks (bf16, fp8)."""
    if str(raw.dtype) == dtype:
        return raw
    if dtype in _EXOTIC_BY_NAME:
        signed = np.ascontiguousarray(raw).view(f"int{8 * raw.itemsize}")
        return torch.from_numpy(signed).view(_EXOTIC_BY_NAME[dtype])
    return raw.view(np.dtype(dtype))


def _fill_leaf(leaf, key: str, arrays: dict):
    if key not in arrays:
        raise KeyError(f"checkpoint missing leaf {key}")
    value = arrays[key]
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
    if tuple(value.shape) != shape:
        raise ValueError(f"{key}: shape {tuple(value.shape)} != {shape}")
    if isinstance(leaf, torch.Tensor):
        src = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(value))
        with torch.no_grad():
            leaf.copy_(src.to(leaf.dtype))
        return leaf
    if isinstance(leaf, (int, float)):
        return type(leaf)(np.asarray(value))
    return np.asarray(value, dtype=np.asarray(leaf).dtype)


def fill_tree(template, arrays: dict, prefix: tuple = ()):
    """``template`` restored from ``arrays`` (key -> array): tensors are
    filled in place, on their device; numpy and number leaves are
    replaced; an object with ``from_checkpoint_tree`` rebuilds itself
    from its filled tree.  Shapes must match."""
    if hasattr(template, "checkpoint_tree"):
        filled = fill_tree(template.checkpoint_tree(), arrays, prefix)
        rebuild = getattr(template, "from_checkpoint_tree", None)
        return rebuild(filled) if rebuild is not None else template
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(fill_tree(v, arrays, prefix + (f,))
                                for f, v in zip(template._fields, template)))
    if isinstance(template, dict):
        return {k: fill_tree(v, arrays, prefix + (str(k),)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(fill_tree(v, arrays, prefix + (f"[{i}]",))
                              for i, v in enumerate(template))
    return _fill_leaf(template, "/".join(prefix), arrays)


# --------------------------------------------------------- durable staging
def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sweep_orphan_tmp(ckpt_dir: str) -> None:
    """Remove ``step_*.tmp`` staging dirs a crashed writer left behind."""
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _hook(crash_hook: Optional[Callable[[str], None]], stage: str) -> None:
    if crash_hook is not None:
        crash_hook(stage)


def write_durable(path: str, write: Callable) -> None:
    """Open ``path``, let ``write(f)`` fill it, then flush and fsync."""
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def write_staged(ckpt_dir: str, step: int,
                 write_files: Callable[[str], None], *,
                 _crash_hook: Optional[Callable[[str], None]] = None) -> str:
    """Write one checkpoint step dir with full crash atomicity.

    ``write_files(tmp_dir)`` writes the step's files durably into the
    staging dir.  ``_crash_hook(stage)`` is invoked after each durability
    boundary ("payload_synced", "staging_synced", "renamed",
    "parent_synced"); a hook that raises simulates a crash there.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    _sweep_orphan_tmp(ckpt_dir)
    os.makedirs(tmp)
    write_files(tmp)
    _hook(_crash_hook, "payload_synced")
    _fsync_path(tmp)
    _hook(_crash_hook, "staging_synced")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _hook(_crash_hook, "renamed")
    _fsync_path(ckpt_dir)
    _hook(_crash_hook, "parent_synced")
    return final


def write_json(path: str, blob: dict) -> None:
    write_durable(path, lambda f: f.write(json.dumps(blob, indent=2).encode()))


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None, *,
                    _crash_hook: Optional[Callable[[str], None]] = None) -> str:
    arrays, dtypes = flatten_with_paths(tree)
    meta = {"step": int(step), "n_leaves": len(arrays), "dtypes": dtypes,
            "extra": extra or {}}

    def write_files(tmp: str) -> None:
        write_durable(os.path.join(tmp, "arrays.npz"), lambda f: np.savez(f, **arrays))
        _hook(_crash_hook, "arrays_synced")
        write_json(os.path.join(tmp, "meta.json"), meta)
        _hook(_crash_hook, "meta_synced")

    return write_staged(ckpt_dir, step, write_files, _crash_hook=_crash_hook)


# -------------------------------------------------------------- discovery
def intact_steps(ckpt_dir: str) -> list[tuple[int, str]]:
    """``(step, kind)`` for every well-formed step dir, newest first;
    ``kind`` is ``"monolithic"`` (``arrays.npz``) or ``"coded"``
    (``manifest.json``).  Debris is skipped, each skip warning once."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in sorted(os.listdir(ckpt_dir), reverse=True):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        path = os.path.join(ckpt_dir, d)
        m = _STEP_RE.match(d)
        if m is None or not os.path.isdir(path):
            _warn_once(path, f"skipping stray checkpoint entry {path!r} "
                             "(not a step_<number> directory)")
            continue
        if not os.path.isfile(os.path.join(path, "meta.json")):
            _warn_once(path, f"skipping malformed checkpoint {path!r} "
                             "(missing meta.json)")
            continue
        if os.path.isfile(os.path.join(path, "arrays.npz")):
            out.append((int(m.group(1)), "monolithic"))
        elif os.path.isfile(os.path.join(path, "manifest.json")):
            out.append((int(m.group(1)), "coded"))
        else:
            _warn_once(path, f"skipping malformed checkpoint {path!r} "
                             "(missing arrays.npz / manifest.json)")
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = intact_steps(ckpt_dir)
    return steps[0][0] if steps else None


def _load_step_dir(path: str) -> tuple[dict, dict]:
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    for k, dt in meta.get("dtypes", {}).items():
        if k in arrays:
            arrays[k] = loaded_array(arrays[k], dt)
    return arrays, meta


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> tuple[dict, dict]:
    """Returns (key -> array, meta); bf16/fp8 leaves come back as CPU torch
    tensors.  With ``step=None`` the newest loadable monolithic checkpoint
    wins (coded and torn ones are skipped with a warning); an explicit
    ``step`` is strict."""
    if step is not None:
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint {path}")
        if not os.path.isfile(os.path.join(path, "arrays.npz")) and \
                os.path.isfile(os.path.join(path, "manifest.json")):
            raise ValueError(f"{path} is an erasure-coded checkpoint; use "
                             "repro_torch.checkpoint.coded.load_coded_checkpoint")
        return _load_step_dir(path)
    for s, kind in intact_steps(ckpt_dir):
        path = os.path.join(ckpt_dir, f"step_{s:08d}")
        if kind != "monolithic":
            _warn_once(path + "#coded", f"skipping erasure-coded checkpoint {path!r} "
                                        "(monolithic loader)")
            continue
        try:
            return _load_step_dir(path)
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
            _warn_once(path + "#torn", f"skipping unreadable checkpoint {path!r} "
                                       f"({e}); falling back to the next newest")
    raise FileNotFoundError(f"no loadable checkpoints under {ckpt_dir}")


def restore_train_state(template: Any, ckpt_dir: str, step: Optional[int] = None) -> Any:
    """Restore into ``template`` (shapes must match); see ``fill_tree``."""
    arrays, _ = load_checkpoint(ckpt_dir, step)
    return fill_tree(template, arrays)
