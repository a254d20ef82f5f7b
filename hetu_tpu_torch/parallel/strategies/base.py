"""Strategy base (counterpart of ``hetu_tpu/parallel/strategies/base.py``):
maps a model's parameters to placements over a mesh.

A strategy gives a :class:`~hetu_tpu_torch.parallel.spec.P` for each
parameter by its name in the PORT's model (``blocks.0.attn.qkv.weight``)
and in the port's layout (a ``Linear`` weight is ``[out, in]``, the
reference's ``[in, out]``), so the reference's column split ``P(None,
"tp")`` of ``qkv_weight`` is ``P("tp", None)`` here.  :meth:`Strategy.place`
turns a model's parameters into DTensors of those placements, in the
model itself.

The JSON files are the reference's: :meth:`Strategy.save_json` writes the
reference's tree paths and layouts (given the model's config, through
:func:`~hetu_tpu_torch.interop.reference_paths`), which the reference's
``Strategy.load_json`` reads, and :meth:`Strategy.load_json` reads a file
the reference wrote.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

from hetu_tpu_torch.parallel.spec import P, placements


def _fit(spec: P, leaf, mesh) -> list:
    """The placements of ``spec`` for ``leaf``, with every entry whose
    mesh-axis product does not divide its dimension replicated (the
    reference's rule), and entries past the leaf's rank dropped."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))  # the whole mesh
    dims = []
    for i, entry in enumerate(spec):
        if i >= leaf.ndim:
            break
        if entry is None:
            dims.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        k = 1
        for a in axes:
            k *= sizes[a]
        dims.append(entry if leaf.shape[i] % k == 0 else None)
    return placements(mesh, dims)


def _to_reference(spec: P, ndim: int, flips: bool, stacked: bool) -> list:
    dims = list(spec) + [None] * (ndim - len(spec))
    dims = dims[:ndim]
    if all(d is None for d in dims):
        return []  # replicated: the reference writes P() as []
    if flips:
        dims = dims[::-1]
    return ([None] if stacked else []) + dims


def _from_reference(spec, ndim: int, flips: bool, stacked: bool) -> P:
    dims = list(spec)
    ref_ndim = ndim + (1 if stacked else 0)
    dims = (dims + [None] * (ref_ndim - len(dims)))[:ref_ndim]
    if stacked:
        dims = dims[1:]
    if flips:
        dims = dims[::-1]
    while dims and dims[-1] is None:
        dims.pop()
    return P(*dims)


class Strategy:
    """Assign partition specs to parameters by name."""

    def param_spec(self, path: str, leaf) -> P:
        """Override: the spec of one parameter, by its name."""
        return P()

    def slot_spec(self, path: str, leaf) -> P:
        """The spec of one optimizer slot — the parameter's by default.
        Override for ZeRO-1 layouts, where slots shard over dp while the
        parameters stay replicated."""
        return self.param_spec(path, leaf)

    def batch_spec(self) -> P:
        return P("dp")

    # ---- dict-level API ----
    def param_specs(self, params: Dict[str, Any]) -> Dict[str, P]:
        return {n: self.param_spec(n, p) for n, p in params.items()}

    def shardings(self, params: Dict[str, Any], mesh) -> Dict[str, list]:
        """Placements per parameter; a dimension the assigned axis product
        does not divide is replicated (the reference's ``_fit``: a 10-class
        head under tp=4 stays whole)."""
        return {n: _fit(self.param_spec(n, p), p, mesh)
                for n, p in params.items()}

    def slot_shardings(self, params: Dict[str, Any], mesh) -> Dict[str, list]:
        """Placements of the optimizer slots (one dict, each slot)."""
        return {n: _fit(self.slot_spec(n, p), p, mesh)
                for n, p in params.items()}

    def place(self, model, mesh) -> Dict[str, Any]:
        """Make ``model``'s parameters DTensors on ``mesh`` by this
        strategy, in the model (each rank keeps its own piece of the
        values it holds whole; no communication).  Returns the new
        ``named_parameters()``."""
        from torch import nn
        from torch.distributed.tensor import DTensor

        from hetu_tpu_torch.parallel.mesh import host_to_device

        shard = self.shardings(dict(model.named_parameters()), mesh)
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            value = p.detach()
            if isinstance(value, DTensor):
                value = value.full_tensor()
            placed = host_to_device(value, mesh, shard[name])
            setattr(model.get_submodule(owner), leaf,
                    nn.Parameter(placed, requires_grad=p.requires_grad))
        return dict(model.named_parameters())

    # ---- JSON round-trip, in the reference's names and layouts ----
    def save_json(self, params: Dict[str, Any], path, config) -> None:
        """Write the specs of ``params`` (a model of ``config``, as
        :mod:`~hetu_tpu_torch.interop` takes it) under the reference's
        tree paths, in its layouts: the file the reference's
        ``Strategy.save_json`` writes for the same model."""
        from hetu_tpu_torch.interop import reference_paths
        refs = reference_paths(config, list(params))
        out = {}
        for name, leaf in params.items():
            key, flips, stacked = refs[name]
            spec = _to_reference(self.param_spec(name, leaf), leaf.ndim,
                                 flips, stacked)
            shape = list(leaf.shape)
            shape = shape[::-1] if flips else shape
            if stacked:
                shape = [getattr(config, "num_layers")] + shape
            if key in out and out[key]["spec"] != spec:
                raise ValueError(f"layers of {key} have different specs")
            out[key] = {"spec": spec, "shape": shape}
        Path(path).write_text(json.dumps(out, indent=1, default=str))

    @staticmethod
    def load_json(path, config) -> "Strategy":
        """A strategy from a file in the reference's format, for a model
        of ``config``: each port parameter takes the spec of its reference
        path, in the port's layout."""
        from hetu_tpu_torch.interop import reference_paths
        table = {k: tuple(tuple(s) if isinstance(s, list) else s
                          for s in v["spec"])
                 for k, v in json.loads(Path(path).read_text()).items()}

        class _Loaded(Strategy):
            def param_spec(self, name, leaf):
                key, flips, stacked = reference_paths(config, [name])[name]
                return _from_reference(table.get(key, ()), leaf.ndim,
                                       flips, stacked)

        return _Loaded()
