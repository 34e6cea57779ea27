"""Erasure-coded checkpointing: MDS parity stripes over the flat state,
after ``repro/checkpoint/coded.py``, in the same format.

A state is flattened to bytes like ``ckpt.py`` (bf16/fp8 ride their
same-width uint views), packed into one lane-aligned buffer by
``FlatLayout.for_bytes`` and split into ``K = N - s`` equal data stripes.
``s`` parity stripes are computed through the gradient-coding encode —
the hand-written ``gc_encode`` kernel when the state lives on the card —
and worker ``i`` of ``N`` holds stripe ``i``.  Lose any ``s`` of the
``N`` shards and the state restores bit-exactly from the ``N - s``
survivors.

Exactness through a float kernel.  The parity matrix is the generalized
Vandermonde ``P[i, j] = (j+1)^i`` (every square submatrix nonsingular:
the MDS property).  Stripes are cut into base-``2^b`` digits sized so
that every partial sum of ``C = P @ G`` stays below ``2^24``, exactly
representable in fp32: integer in, integer out, in any summation order
(TF32 off).  Decode subtracts the survivors' contribution (the same
exact encode), solves the ``|missing| x |missing|`` integer system in
float64 on the host, rounds, and checks every rebuilt stripe against the
manifest's crc32.  Parity digits are stored byte-packed at their minimal
width.

A torn, missing or bit-flipped shard is demoted to "lost"; restore
succeeds while any ``N - s`` shards survive and raises ``ShardLossError``
when they do not.  The same state gives the same ``manifest.json`` and
the same shard payloads in both packages.
"""
from __future__ import annotations

import json
import os
import sys
import zlib
from collections.abc import Iterator
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..core.flat import LANE, FlatLayout
from ..device import resolve_device
from ..kernels import ops
from .ckpt import (
    _hook,
    fill_tree,
    flatten_with_paths,
    intact_steps,
    loaded_array,
    tree_items,
    write_durable,
    write_json,
    write_staged,
)

__all__ = ["CheckpointError", "CodedSpec", "ShardCorruptionError",
           "ShardLossError", "latest_coded_step", "load_coded_checkpoint",
           "restore_coded_train_state", "save_coded_checkpoint"]

#: fp32 mantissa width: every parity partial sum must stay strictly
#: below 2**_F32_EXACT_BITS so the fp32 accumulate is exact.
_F32_EXACT_BITS = 24

MANIFEST_VERSION = 1
PARITY_CODE = "vandermonde-v1"


class CheckpointError(RuntimeError):
    """Base class for coded-checkpoint failures."""


class ShardLossError(CheckpointError):
    """More shards lost than the (N, s) contract tolerates."""


class ShardCorruptionError(CheckpointError):
    """Decode produced bytes that fail the manifest's integrity check."""


@dataclass(frozen=True)
class CodedSpec:
    """The (N, s) storage-coding contract a checkpoint is written under:
    ``n_shards`` (N) stripes, one per worker, ``parity`` (s) of them
    parity, so any ``N - s`` survivors restore.  ``digit_bits`` is the
    payload digit width (``None``: the widest of 16/8 that keeps every
    parity sum exact in fp32)."""

    n_shards: int
    parity: int
    digit_bits: Optional[int] = None
    lane: int = LANE

    def __post_init__(self):
        if not (0 < self.parity < self.n_shards):
            raise ValueError(f"need 0 < parity < n_shards, got "
                             f"s={self.parity}, N={self.n_shards}")
        if self.digit_bits is not None and self.digit_bits not in (8, 16):
            raise ValueError(f"digit_bits must be 8, 16, or None (auto); "
                             f"got {self.digit_bits}")
        b = self.digit_bits
        if b is not None and self.max_parity_value(b) >= 2 ** _F32_EXACT_BITS:
            raise ValueError(
                f"digit_bits={b} overflows the fp32-exact budget for "
                f"(N={self.n_shards}, s={self.parity}): max parity sum "
                f"{self.max_parity_value(b)} >= 2^{_F32_EXACT_BITS}")
        if self.digit_bits is None and \
                self.max_parity_value(8) >= 2 ** _F32_EXACT_BITS:
            raise ValueError(
                f"(N={self.n_shards}, s={self.parity}) has no fp32-exact "
                f"digit width: the Vandermonde row sum {self._row_sum()} "
                f"leaves no payload bits under 2^{_F32_EXACT_BITS}")

    @property
    def k_data(self) -> int:
        return self.n_shards - self.parity

    def _row_sum(self) -> int:
        """Largest parity-row coefficient sum: sum_j (j+1)^(s-1)."""
        return int(sum((j + 1) ** (self.parity - 1) for j in range(self.k_data)))

    def max_parity_value(self, digit_bits: Optional[int] = None) -> int:
        b = self.resolved_digit_bits() if digit_bits is None else digit_bits
        return (2 ** b - 1) * self._row_sum()

    def resolved_digit_bits(self) -> int:
        if self.digit_bits is not None:
            return self.digit_bits
        return next(b for b in (16, 8)
                    if self.max_parity_value(b) < 2 ** _F32_EXACT_BITS)

    def parity_byte_width(self) -> int:
        """Bytes per stored parity digit (minimal little-endian width)."""
        return (int(self.max_parity_value()).bit_length() + 7) // 8

    def parity_matrix(self) -> np.ndarray:
        """(s, K) generalized Vandermonde P[i, j] = (j+1)^i."""
        j = np.arange(1, self.k_data + 1, dtype=np.float64)
        i = np.arange(self.parity, dtype=np.float64)
        return j[None, :] ** i[:, None]

    def storage_overhead(self) -> float:
        """Parity bytes per payload byte (padding excluded)."""
        digit_bytes = self.resolved_digit_bits() // 8
        return self.parity * self.parity_byte_width() / (self.k_data * digit_bytes)

    def to_dict(self) -> dict:
        return {"n_shards": int(self.n_shards), "parity": int(self.parity),
                "digit_bits": int(self.resolved_digit_bits()),
                "lane": int(self.lane)}

    @classmethod
    def from_dict(cls, blob: dict) -> "CodedSpec":
        return cls(n_shards=int(blob["n_shards"]), parity=int(blob["parity"]),
                   digit_bits=int(blob["digit_bits"]), lane=int(blob["lane"]))


# --------------------------------------------------------------- byte plumbing
def _leaf_records(tree):
    """(records, byte_leaves): the manifest contract per leaf (key, true
    dtype, uint storage dtype, shape, bytes) and each leaf's flat uint8
    view, in flattening order."""
    arrays, dtypes = flatten_with_paths(tree)
    records, byte_leaves = [], []
    for key, arr in arrays.items():
        flat = np.ascontiguousarray(arr).reshape(-1)
        byte = flat.view(np.uint8) if flat.size else flat.astype(np.uint8)
        records.append({"key": key, "dtype": dtypes[key],
                        "store_dtype": str(arr.dtype),
                        "shape": [int(d) for d in arr.shape],
                        "nbytes": int(byte.size)})
        byte_leaves.append(byte)
    return records, byte_leaves


def _pack_uints(vals: np.ndarray, width: int) -> np.ndarray:
    """(..., D) uint64 -> (..., D*width) uint8, little-endian digits."""
    out = np.empty(vals.shape + (width,), np.uint8)
    for k in range(width):
        out[..., k] = (vals >> np.uint64(8 * k)) & np.uint64(0xFF)
    return out.reshape(vals.shape[:-1] + (-1,))


def _unpack_uints(raw: np.ndarray, width: int) -> np.ndarray:
    """Inverse of ``_pack_uints``."""
    parts = raw.reshape(raw.shape[:-1] + (-1, width))
    vals = np.zeros(parts.shape[:-1], np.uint64)
    for k in range(width):
        vals |= parts[..., k].astype(np.uint64) << np.uint64(8 * k)
    return vals


def _stripes_to_digits(stripes: torch.Tensor, bits: int) -> torch.Tensor:
    """(K, stripe_bytes) uint8 -> (K, D_digits) float32, exact (on the
    stripes' device)."""
    if bits == 8:
        return stripes.float()
    return (stripes.view(torch.int16).to(torch.int32) & 0xFFFF).float()


def _encode_digits(p_sub: np.ndarray, stripes: np.ndarray, bits: int,
                   device) -> np.ndarray:
    """Integer-exact C = P @ digits(stripes) through ``ops.encode`` on
    ``device`` (the ``gc_encode`` kernel on CUDA, its plain version on
    the CPU): both operands are integer-valued fp32 within the 2^24
    budget, so the result is the exact integer matrix, as float64."""
    g = _stripes_to_digits(torch.from_numpy(np.ascontiguousarray(stripes)).to(device),
                           bits)
    p = torch.as_tensor(np.asarray(p_sub, np.float32), device=device)
    return ops.encode(p, g).cpu().numpy().astype(np.float64)


def _solve_digits(p_lost: np.ndarray, rhs: np.ndarray, bits: int,
                  path: str) -> np.ndarray:
    """The lost stripes' digits from ``p_lost @ digits = rhs`` (float64,
    rounded), checked to be integer digits in range."""
    sol = np.linalg.solve(p_lost, rhs)
    digits = np.rint(sol)
    if np.any(digits < 0) or np.any(digits >= 2 ** bits) or \
            float(np.max(np.abs(sol - digits), initial=0.0)) > 0.25:
        raise ShardCorruptionError(
            f"{path}: decode produced out-of-range digits — surviving "
            "shards are inconsistent (undetected corruption?)")
    return digits


def _digits_to_stripe(digits: np.ndarray, bits: int) -> np.ndarray:
    """(D_digits,) integer array -> (stripe_bytes,) uint8."""
    dtype = np.uint16 if bits == 16 else np.uint8
    return np.ascontiguousarray(digits.astype(dtype)).view(np.uint8)


def _crc(byte_arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(byte_arr)) & 0xFFFFFFFF


def _shard_name(i: int) -> str:
    return f"shard_{i:03d}.npz"


def _state_device(tree) -> torch.device:
    """The device of the state's first tensor (the CPU when it holds none)."""
    for _, leaf in tree_items(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


# ------------------------------------------------------------------- save
def save_coded_checkpoint(ckpt_dir: str, step: int, tree: Any,
                          spec: CodedSpec, extra: Optional[dict] = None, *,
                          device=None,
                          _crash_hook: Optional[Callable[[str], None]] = None,
                          ) -> str:
    """Shard ``tree`` across ``spec.n_shards`` workers with ``spec.parity``
    parity stripes; returns the published step dir.  ``tree`` may be a
    leaf stream (``ckpt.flatten_with_paths``).  The parity encode runs on
    ``device``: by default the state's device, CUDA for a stream.
    Atomicity and durability ride ``ckpt.write_staged``."""
    if device is None:
        device = "cuda" if isinstance(tree, Iterator) else _state_device(tree)
    device = resolve_device(device)
    records, byte_leaves = _leaf_records(tree)
    layout = FlatLayout.for_bytes([r["nbytes"] for r in records], spec.k_data,
                                  lane=spec.lane)
    buf = np.zeros(layout.level_sizes[0], np.uint8)
    for j, off in zip(layout.level_leaves[0], layout.level_offsets[0]):
        buf[off:off + byte_leaves[j].size] = byte_leaves[j]
    del byte_leaves
    stripes = buf.reshape(spec.k_data, -1)
    stripe_bytes = int(stripes.shape[1])
    bits = spec.resolved_digit_bits()
    if stripe_bytes % (bits // 8):
        raise ValueError(f"stripe width {stripe_bytes} is not a multiple of "
                         f"the {bits}-bit digit size")

    parity = _encode_digits(spec.parity_matrix(), stripes, bits, device)
    if not np.all(parity == np.rint(parity)) or \
            float(parity.max(initial=0.0)) > spec.max_parity_value():
        raise AssertionError("parity encode left the fp32-exact budget — "
                             "CodedSpec validation is out of sync")
    width = spec.parity_byte_width()
    parity_bytes = _pack_uints(parity.astype(np.uint64), width)
    del parity

    shards = [{"file": _shard_name(i), "role": "data", "crc32": _crc(stripes[i]),
               "nbytes": int(stripes[i].size)} for i in range(spec.k_data)]
    shards += [{"file": _shard_name(spec.k_data + i), "role": "parity",
                "crc32": _crc(parity_bytes[i]), "nbytes": int(parity_bytes[i].size)}
               for i in range(spec.parity)]
    manifest = {
        "version": MANIFEST_VERSION,
        "kind": "coded",
        "parity_code": PARITY_CODE,
        "step": int(step),
        "spec": spec.to_dict(),
        "byteorder": sys.byteorder,
        "parity_byte_width": width,
        "stripe_bytes": stripe_bytes,
        "payload_bytes": int(sum(r["nbytes"] for r in records)),
        "layout": layout.to_dict(),
        "leaves": records,
        "shards": shards,
        "extra": extra or {},
    }
    meta = {"step": int(step), "kind": "coded", "n_leaves": len(records),
            "extra": extra or {}}

    def write_files(tmp: str) -> None:
        payloads = list(stripes) + list(parity_bytes)
        for i, payload in enumerate(payloads):
            write_durable(os.path.join(tmp, _shard_name(i)),
                          lambda f, p=payload: np.savez(f, stripe=p))
        _hook(_crash_hook, "shards_synced")
        write_json(os.path.join(tmp, "manifest.json"), manifest)
        write_json(os.path.join(tmp, "meta.json"), meta)
        _hook(_crash_hook, "manifest_synced")

    return write_staged(ckpt_dir, step, write_files, _crash_hook=_crash_hook)


# ------------------------------------------------------------------- load
def latest_coded_step(ckpt_dir: str) -> Optional[int]:
    for s, kind in intact_steps(ckpt_dir):
        if kind == "coded":
            return s
    return None


def _read_shard(path: str, entry: dict) -> Optional[np.ndarray]:
    """One shard file -> its payload, or None when the shard is lost:
    missing file, torn write, or crc/length mismatch."""
    try:
        with np.load(path) as z:
            arr = np.asarray(z["stripe"])
    except Exception:  # noqa: BLE001 - any unreadable shard is just lost
        return None
    if arr.dtype != np.uint8 or int(arr.size) != int(entry["nbytes"]):
        return None
    if _crc(arr) != int(entry["crc32"]):
        return None
    return arr


def load_coded_checkpoint(ckpt_dir: str, step: Optional[int] = None, *,
                          missing: Sequence[int] = (), device="cuda",
                          ) -> tuple[dict, dict]:
    """Returns (key -> array, manifest), decoding from whatever shards
    survive; bf16/fp8 leaves come back as CPU torch tensors.  ``missing``
    marks shard ids to treat as lost on top of real file loss (the
    worker-death path passes the dead workers' ids).  The survivors'
    encode runs on ``device``: CUDA unless the caller asks for the CPU,
    raising when CUDA is asked for and absent."""
    device = resolve_device(device)
    if step is None:
        step = latest_coded_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no coded checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"unreadable coded manifest in {path}: {e}") from e
    if manifest.get("parity_code") != PARITY_CODE:
        raise CheckpointError(
            f"unknown parity code {manifest.get('parity_code')!r} in {path}")
    if manifest.get("byteorder") != sys.byteorder:
        raise CheckpointError(
            f"checkpoint written on a {manifest.get('byteorder')}-endian "
            f"host cannot decode on this {sys.byteorder}-endian one")
    spec = CodedSpec.from_dict(manifest["spec"])
    missing_set = {int(i) for i in missing}
    bad = missing_set - set(range(spec.n_shards))
    if bad:
        raise ValueError(f"missing shard ids {sorted(bad)} out of range "
                         f"[0, {spec.n_shards})")

    shards = manifest["shards"]
    width = int(manifest["parity_byte_width"])
    bits = spec.resolved_digit_bits()
    data: dict[int, np.ndarray] = {}
    parity: dict[int, np.ndarray] = {}
    for i, entry in enumerate(shards):
        if i in missing_set:
            continue
        payload = _read_shard(os.path.join(path, entry["file"]), entry)
        if payload is None:
            continue
        if entry["role"] == "data":
            data[i] = payload
        else:
            parity[i - spec.k_data] = payload

    lost = [j for j in range(spec.k_data) if j not in data]
    if lost:
        if len(parity) < len(lost):
            raise ShardLossError(
                f"{path}: {len(lost)} data shard(s) {lost} lost with only "
                f"{len(parity)} intact parity shard(s) — the (N={spec.n_shards}, "
                f"s={spec.parity}) contract tolerates at most {spec.parity} "
                f"losses; restore needs any {spec.k_data} of {spec.n_shards} shards")
        rows = sorted(parity)[:len(lost)]
        p = spec.parity_matrix()
        known = sorted(data)
        rhs = np.stack([_unpack_uints(parity[r], width).astype(np.float64)
                        for r in rows])
        if known:
            rhs -= _encode_digits(p[np.ix_(rows, known)],
                                  np.stack([data[j] for j in known]), bits, device)
        digits = _solve_digits(p[np.ix_(rows, lost)], rhs, bits, path)
        del rhs
        for pos, j in enumerate(lost):
            stripe = _digits_to_stripe(digits[pos], bits)
            if _crc(stripe) != int(shards[j]["crc32"]):
                raise ShardCorruptionError(
                    f"{path}: reconstructed shard {j} fails its manifest "
                    "crc32 — surviving shards are inconsistent")
            data[j] = stripe

    buf = np.concatenate([data[j] for j in range(spec.k_data)])
    layout = FlatLayout.from_dict(manifest["layout"])
    arrays = {}
    offsets = dict(zip(layout.level_leaves[0], layout.level_offsets[0]))
    for j, rec in enumerate(manifest["leaves"]):
        raw = buf[offsets[j]:offsets[j] + int(rec["nbytes"])]
        store = np.dtype(rec["store_dtype"])
        arr = raw.view(store) if raw.size else np.zeros(0, store)
        arrays[rec["key"]] = loaded_array(arr.reshape(rec["shape"]), rec["dtype"])
    return arrays, manifest


def restore_coded_train_state(template: Any, ckpt_dir: str,
                              step: Optional[int] = None, *,
                              missing: Sequence[int] = ()) -> Any:
    """Restore into ``template`` from any ``N - s`` surviving shards
    (shapes must match; tensors are filled in place).  The survivors'
    encode runs on the template's device."""
    arrays, _ = load_coded_checkpoint(ckpt_dir, step, missing=missing,
                                      device=_state_device(template))
    return fill_tree(template, arrays)
