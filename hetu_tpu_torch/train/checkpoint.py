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
name, then ``step``), the model state tree (a batch norm's ``mean`` and
``var``), the rng words and the step.  So a checkpoint crosses between
the two packages in both directions; :mod:`hetu_tpu_torch.interop`
converts the layouts of the models it knows (``config`` is the model's
``GPTConfig`` or ``MoEConfig``, or the model itself for the CTR and CNN
models).  With ``config=None`` the state is any nested dict of numpy
arrays or tensors, its leaves in the same order (keys sorted, depth
first), as the reference saves a plain pytree.
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
from hetu_tpu_torch.parallel.spec import is_dtensor

_FORMAT_VERSION = 2


class CheckpointError(ValueError):
    """A checkpoint could not be loaded (corrupt file or format/shape
    mismatch)."""


class CheckpointCorruptError(CheckpointError):
    """The file on disk is not a readable checkpoint: truncated write,
    bit rot, or garbage bytes."""


def _paths(tree, prefix: str):
    """(path, leaf) of a nested dict in JAX's flatten order (keys sorted,
    depth first), the path written as ``jax.tree_util.keystr`` writes dict
    keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def _flatten(tree) -> list:
    return [leaf for _, leaf in _paths(tree, "")]


def _unflatten(template, leaves):
    """``template``'s nested dicts with its leaves taken, in order, from
    the iterator ``leaves``."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    return next(leaves)


def _whole(d: dict) -> dict:
    """Name -> tensor with every DTensor gathered whole (a collective:
    every rank of its mesh calls it)."""
    return {n: t.full_tensor() if is_dtensor(t) else t for n, t in d.items()}


def _sharded(state) -> bool:
    return any(is_dtensor(t) for t in state.params.values())


def _trees(state, config) -> list:
    """The reference ``TrainState``'s children, in its order (a sharded
    state's tensors gathered whole)."""
    opt = state.opt_state
    if opt:
        opt = dict(opt, slots={k: _whole(v)
                               for k, v in opt["slots"].items()})
    return [interop.params_to_jax(_whole(state.params), config),
            interop.opt_state_to_jax(opt, config),
            interop.state_to_jax(_whole(state.model_state), config),
            np.asarray(state.rng, np.uint32),
            np.asarray(state.step, np.int32)]


def _host(leaf):
    """A leaf as numpy: a tensor is read back from its device (a bf16
    tensor as float32, exact)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _leaves(state, config) -> list:
    """``state``'s leaves in the reference's flatten order: a ``TrainState``
    of the model of ``config``, or (``config=None``) a nested dict."""
    if config is None:
        if not isinstance(state, dict):
            raise TypeError(
                f"a {type(state).__name__} is saved with its model's "
                "config (checkpoint.save(path, state, config)); "
                "config=None takes a nested dict of arrays or tensors")
        return [_host(leaf) for leaf in _flatten(state)]
    return [leaf for tree in _trees(state, config) for leaf in _flatten(tree)]


def state_dict(state, config) -> dict:
    """``{path: numpy array}`` of ``state`` (a port ``TrainState`` of the
    model of ``config``), keyed as the reference's ``state_dict`` keys its
    ``TrainState``: ``[<flat index i>]`` for its ``i``-th child, then the
    dict keys.  The arrays are copies, not views of the live tensors."""
    return {path: np.array(leaf)
            for i, tree in enumerate(_trees(state, config))
            for path, leaf in _paths(tree, f"[<flat index {i}>]")}


def save(path, state, config=None, *,
         extra: Optional[dict] = None) -> None:
    """Write ``state`` (a port ``TrainState`` of the model of ``config``,
    or with ``config=None`` a nested dict of arrays or tensors) to
    ``path``.  A sharded state (DTensors on a mesh) is saved whole, in the
    same format: every rank calls ``save``, the pieces are gathered, rank
    0 writes the file and the others wait for it."""
    path = Path(path)
    leaves = _leaves(state, config)
    sharded = config is not None and _sharded(state)
    if sharded:
        import torch.distributed as dist
        if dist.get_rank() != 0:
            dist.barrier()
            return
    try:
        _write(path, leaves, extra)
    finally:
        if sharded:
            dist.barrier()


def _write(path, leaves, extra) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
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


def _open(path):
    try:
        return np.load(path, allow_pickle=False)
    except zipfile.BadZipFile as e:
        raise CheckpointCorruptError(
            f"{path} is truncated or corrupt (not a readable npz archive: "
            f"{e}); resume from an older checkpoint") from e
    except ValueError as e:
        raise CheckpointCorruptError(
            f"{path} is not a v2 (npz) checkpoint ({e})") from e


def _header(z, path) -> dict:
    try:
        return json.loads(bytes(z["header"]).decode("utf-8"))
    except (KeyError, UnicodeDecodeError, json.JSONDecodeError,
            zipfile.BadZipFile) as e:
        raise CheckpointCorruptError(
            f"{path}: checkpoint header missing or unreadable ({e})") from e


def read_header(path) -> dict:
    """Just the JSON header of a checkpoint: ``{version, n_leaves,
    dtypes, shapes, rng, extra}``; no leaf is decoded."""
    with _open(path) as z:
        return _header(z, path)


def _read(path):
    with _open(path) as z:
        header = _header(z, path)
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


def _from_template(arr, want):
    """A loaded leaf in the kind of its template leaf: a tensor of the
    template's dtype on its device, or a numpy array of its dtype."""
    if isinstance(want, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=want.device,
                                                  dtype=want.dtype)
    if hasattr(want, "dtype") and arr.dtype != want.dtype:
        return arr.astype(want.dtype)
    return arr


def _like(value, want):
    """A whole loaded value placed as ``want`` is: on a DTensor's mesh with
    its placements (each rank keeps its piece), else as it is."""
    if not is_dtensor(want):
        return value
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(value.to(want.device_mesh.device_type),
                             want.device_mesh, want.placements,
                             src_data_rank=None)


def load(path, state, config=None, *, restore_rng: bool = True):
    """Load ``path`` into ``state`` (a port ``TrainState`` of the model of
    ``config``): parameters, slots and state buffers are copied into the
    state's own tensors, in place.  Returns the state with the saved
    steps and rng words.  With ``config=None`` ``state`` is a nested dict
    (the template) and a new one comes back, each leaf in its template
    leaf's kind, dtype and device.  Raises :class:`CheckpointCorruptError`
    for an unreadable file and :class:`CheckpointError` for one of another
    architecture.  A sharded state loads by placing each whole value again
    on its tensors' mesh, whatever mesh saved it (every rank calls
    ``load``)."""
    header, leaves = _read(path)
    template = _trees(state, config) if config is not None else [state]
    flat = [leaf for tree in template for leaf in _flatten(tree)]
    if len(leaves) != len(flat):
        raise CheckpointError(
            f"checkpoint has {len(leaves)} leaves, template {len(flat)}")
    for i, (arr, want) in enumerate(zip(leaves, flat)):
        shape = tuple(want.shape if hasattr(want, "shape")
                      else np.shape(want))
        if tuple(arr.shape) != shape:
            raise CheckpointError(
                f"checkpoint leaf {i} shape {arr.shape} != template "
                f"{shape}; wrong architecture?")
    if config is None:
        out = _unflatten(state, iter(
            _from_template(arr, want) for arr, want in zip(leaves, flat)))
        if restore_rng:
            hrng.set_seed_status(*header["rng"])
        return out
    it = iter(leaves)
    params, opt, model_state, rng, step = (_unflatten(t, it)
                                           for t in template)
    loaded = interop.params_from_jax(params, config)
    opt_state = interop.opt_state_from_jax(opt, config)
    buffers = interop.state_from_jax(model_state, config)
    with torch.no_grad():
        for name, p in state.params.items():
            p.copy_(_like(loaded[name], p))
        for slot, d in state.opt_state.get("slots", {}).items():
            for name, t in d.items():
                t.copy_(_like(opt_state["slots"][slot][name], t))
        for name, t in state.model_state.items():
            t.copy_(_like(buffers[name], t))
    if state.opt_state:
        state.opt_state["step"] = opt_state["step"]
    state.rng = np.asarray(rng, np.uint32)
    state.step = int(step)
    if restore_rng:
        hrng.set_seed_status(*header["rng"])
    return state
