"""Checkpoint save/load in the JAX package's format (counterpart of
``hetu_tpu/train/checkpoint.py``).

An ``np.savez`` archive — no pickle anywhere — with a JSON ``header``
member (``version``, ``n_leaves``, ``dtypes``, ``shapes``, ``rng`` = the
global (seed, seqnum), ``extra``) and one ``leaf_<i>`` per leaf; bf16
leaves are stored as raw bytes.  The file is written to a sibling and
renamed into place, so a crash never destroys the previous checkpoint.

The leaves are those of the reference's ``TrainState`` in its flatten
order: the parameter tree (dict keys sorted, blocks stacked ``[L, ...]``,
matmul weights ``[in, out]``), the optimizer state (``slots`` by sorted
name, then ``step``), the model state, the rng words and the step.  So a
checkpoint crosses between the two packages in both directions;
:mod:`hetu_tpu_torch.interop` converts the layouts.  Only GPT states are
laid out so far (``config`` is the model's ``GPTConfig``).
"""

from __future__ import annotations

import json
import os
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from hetu_tpu_torch import interop
from hetu_tpu_torch import rng as hrng

_FORMAT_VERSION = 2


class CheckpointError(ValueError):
    """A checkpoint could not be loaded (corrupt file or format/shape
    mismatch)."""


class CheckpointCorruptError(CheckpointError):
    """The file on disk is not a readable checkpoint: truncated write,
    bit rot, or garbage bytes."""


def _flatten(tree) -> list:
    """Leaves in JAX's order for nested dicts: keys sorted, depth first."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    return [tree]


def _unflatten(template, leaves):
    """``template``'s nested dicts with its leaves taken, in order, from
    the iterator ``leaves``."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    return next(leaves)


def _trees(state, config) -> list:
    """The reference ``TrainState``'s children, in its order."""
    return [interop.params_to_jax(state.params, config),
            interop.opt_state_to_jax(state.opt_state, config),
            {k: np.asarray(v) for k, v in state.model_state.items()},
            np.asarray(state.rng, np.uint32),
            np.asarray(state.step, np.int32)]


def save(path, state, config, *, extra: Optional[dict] = None) -> None:
    """Write ``state`` (a port ``TrainState`` of a GPT model) to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = [leaf for tree in _trees(state, config)
              for leaf in _flatten(tree)]
    seed, seqnum = hrng.get_seed_status()
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    header = {
        "version": _FORMAT_VERSION,
        "n_leaves": len(leaves),
        "dtypes": [a.dtype.name for a in arrays.values()],
        "shapes": [list(a.shape) for a in arrays.values()],
        "rng": [int(seed), int(seqnum)],
        "extra": extra or {},
    }
    arrays["header"] = np.frombuffer(json.dumps(header).encode("utf-8"),
                                     dtype=np.uint8)
    tmp = path.with_name(path.name + ".tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if tmp.exists():  # failed write: leave no tmp file behind
            tmp.unlink()


def _leaf(arr, dtype: str, shape) -> np.ndarray:
    """A stored leaf as numpy; bf16 raw bytes come back as float32 (every
    bf16 value is exact in float32, and the port's state is float32)."""
    if dtype == "bfloat16":
        raw = torch.frombuffer(bytearray(arr.tobytes()), dtype=torch.bfloat16)
        return raw.float().reshape(shape).numpy()
    want = np.dtype(dtype)
    if arr.dtype != want:
        arr = np.frombuffer(arr.tobytes(), want).reshape(shape)
    return arr


def _read(path):
    try:
        z = np.load(path, allow_pickle=False)
    except zipfile.BadZipFile as e:
        raise CheckpointCorruptError(
            f"{path} is truncated or corrupt (not a readable npz archive: "
            f"{e}); resume from an older checkpoint") from e
    except ValueError as e:
        raise CheckpointCorruptError(
            f"{path} is not a v2 (npz) checkpoint ({e})") from e
    with z:
        try:
            header = json.loads(bytes(z["header"]).decode("utf-8"))
        except (KeyError, UnicodeDecodeError, json.JSONDecodeError,
                zipfile.BadZipFile) as e:
            raise CheckpointCorruptError(
                f"{path}: checkpoint header missing or unreadable ({e})"
            ) from e
        if header["version"] > _FORMAT_VERSION:
            raise CheckpointError(
                f"checkpoint format version {header['version']} is newer "
                f"than supported ({_FORMAT_VERSION})")
        try:
            leaves = [_leaf(z[f"leaf_{i}"], header["dtypes"][i],
                            header["shapes"][i])
                      for i in range(header["n_leaves"])]
        except (KeyError, zipfile.BadZipFile, OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"{path}: checkpoint data is truncated or corrupt ({e})"
            ) from e
        except TypeError as e:  # a dtype numpy does not know (fp8)
            raise CheckpointError(
                f"{path}: a leaf's dtype is not supported ({e})") from e
    return header, leaves


def load(path, state, config, *, restore_rng: bool = True):
    """Load ``path`` into ``state`` (a port ``TrainState`` of a GPT model
    of ``config``): parameters and slots are copied into the state's own
    tensors, in place.  Returns the state with the saved steps and rng
    words.  Raises :class:`CheckpointCorruptError` for an unreadable file
    and :class:`CheckpointError` for one of another architecture."""
    header, leaves = _read(path)
    template = _trees(state, config)
    flat = [leaf for tree in template for leaf in _flatten(tree)]
    if len(leaves) != len(flat):
        raise CheckpointError(
            f"checkpoint has {len(leaves)} leaves, template {len(flat)}")
    for i, (arr, want) in enumerate(zip(leaves, flat)):
        if tuple(arr.shape) != tuple(np.shape(want)):
            raise CheckpointError(
                f"checkpoint leaf {i} shape {arr.shape} != template "
                f"{tuple(np.shape(want))}; wrong architecture?")
    it = iter(leaves)
    params, opt, model_state, rng, step = (_unflatten(t, it)
                                           for t in template)
    loaded = interop.params_from_jax(params, config)
    opt_state = interop.opt_state_from_jax(opt, config)
    with torch.no_grad():
        for name, p in state.params.items():
            p.copy_(loaded[name])
        for slot, d in state.opt_state.get("slots", {}).items():
            for name, t in d.items():
                t.copy_(opt_state["slots"][slot][name])
    if state.opt_state:
        state.opt_state["step"] = opt_state["step"]
    state.model_state = {k: torch.as_tensor(v)
                         for k, v in model_state.items()}
    state.rng = np.asarray(rng, np.uint32)
    state.step = int(step)
    if restore_rng:
        hrng.set_seed_status(*header["rng"])
    return state
