"""Rank bodies of the port's sequence-, pipeline- and expert-parallel tests
and of ``ShardedGPT``'s.

Each function runs in every rank process of a ``gloo`` world started by
``hetu_tpu_torch.parallel.ranks.run`` from ``tests/test_torch_ring_attention.py``,
``tests/test_torch_pipeline.py`` or ``tests/test_torch_gpt_sharded.py``
(through :func:`run_cases`).  This module imports
neither ``jax`` nor ``hetu_tpu``; the test files build the references in
their own process and compare."""

from __future__ import annotations

import sys

import numpy as np
import torch


def run_cases(rank, world, cases):
    """Every case of ``cases`` (``{id: (function name, spec)}``) in turn;
    ``{id: result}``, and whether jax was loaded in this rank."""
    out = {cid: globals()[name](rank, world, spec)
           for cid, (name, spec) in cases.items()}
    out["_jax_loaded"] = "jax" in sys.modules or any(
        m == "hetu_tpu" or m.startswith("hetu_tpu.") for m in sys.modules)
    return out


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _mesh(axes):
    from hetu_tpu_torch.parallel import make_mesh
    return make_mesh(device="cpu", **axes)


def _chunk(x, i, n, dim):
    return torch.tensor(np.ascontiguousarray(np.split(x, n, axis=dim)[i]))


def seq_attention(rank, world, spec):
    """The kernel ring, the plain ring and Ulysses on this rank's sequence
    block of ``spec["q"/"k"/"v"]`` at sp = world, causal and not: each
    one's O block and its dQ/dK/dV blocks under the cotangent
    ``spec["w"]``; and whether Ulysses refuses 3 heads."""
    from hetu_tpu_torch.parallel.ring_attention import (
        ring_attention, ring_attention_plain,
    )
    from hetu_tpu_torch.parallel.ulysses import ulysses_attention
    mesh = _mesh({"sp": world})
    out = {}
    for name, fn in (("ring", ring_attention), ("plain", ring_attention_plain),
                     ("ulysses", ulysses_attention)):
        for causal in (False, True):
            q, k, v = (_chunk(spec[x], rank, world, 2).requires_grad_(True)
                       for x in "qkv")
            w = _chunk(spec["w"], rank, world, 2)
            o = fn(q, k, v, mesh, causal=causal)
            (o * w).sum().backward()
            out[(name, causal)] = [_np(t) for t in (o, q.grad, k.grad,
                                                    v.grad)]
    try:
        x = torch.zeros(1, 3, 4, 2)
        ulysses_attention(x, x, x, mesh)
        out["bad_heads"] = None
    except ValueError as e:
        out["bad_heads"] = str(e)
    return out


def _tanh_block(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def gpipe(rank, world, spec):
    """``GPipe`` at pp = world on the tanh block: each case's output, the
    gradient of ``sum(out * w)`` for this rank's stage rows of ``w``/``b``
    and the input's gradient."""
    from hetu_tpu_torch.parallel.pipeline import GPipe
    mesh = _mesh({"pp": world})
    out = {}
    for cid, case in spec["cases"].items():
        layers = {k: torch.tensor(v) for k, v in case["layers"].items()}
        h = torch.tensor(case["h"]).requires_grad_(True)
        pipe = GPipe(_tanh_block, mesh, n_microbatches=case["M"],
                     remat=case["remat"])
        if case.get("bounds"):
            stacked, mask = pipe.stack_params_unequal(layers, case["bounds"])
        else:
            stacked, mask = pipe.stack_params(layers), None
        stacked = {k: v.detach().requires_grad_(True)
                   for k, v in stacked.items()}
        y = pipe(stacked, h, layer_mask=mask) * case.get("scale", 1.0)
        (y * torch.tensor(case["w"])).sum().backward()
        out[cid] = dict(y=_np(y), dh=_np(h.grad),
                        dw=_np(stacked["w"].grad[rank]),
                        db=_np(stacked["b"].grad[rank]),
                        mask=None if mask is None else _np(mask))
    return out


def moe_ep(rank, world, spec):
    """``MoELayer`` at ep = world from the reference's weights: its output,
    aux, dropped share, and the gradients of ``sum(out * w) + aux`` (this
    rank's expert rows, the gate's, the input's)."""
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.layers.moe import Expert, MoELayer, TopKGate
    mesh = _mesh({"ep": world})
    D, E, Fz = spec["D"], spec["E"], spec["F"]
    gen = torch.Generator().manual_seed(0)
    plain = MoELayer(TopKGate(D, E, 2, generator=gen),
                     Expert(E, D, Fz, generator=gen),
                     capacity_factor=spec["cf"])
    plain.load_state_dict(interop.params_from_jax(spec["params"], plain))
    layer = plain if spec.get("unsharded") else MoELayer(
        plain.gate, plain.experts, capacity_factor=spec["cf"], mesh=mesh)
    x = torch.tensor(spec["x"]).requires_grad_(True)
    y, aux, m = layer(x, return_metrics=True)
    ((y * torch.tensor(spec["w"])).sum() + aux).backward()
    ex = layer.experts
    local = {n: getattr(ex, n) for n in ("w1", "b1", "w2", "b2")}
    return dict(y=_np(y), aux=float(aux), dropped=float(m["dropped_frac"]),
                dx=_np(x.grad), dgate=_np(layer.gate.gate_w.grad),
                placement=str(tuple(getattr(ex.w1, "placements", ()))),
                local=list(_local(ex.w1).shape),
                **{f"d{n}": _np(_local(p.grad)) for n, p in local.items()})


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def sharded_gpt(rank, world, spec):
    """``ShardedGPT`` on ``spec["mesh"]`` from the reference's tree: the
    first step's gradients (this rank's shards), then ``spec["steps"]``
    Adam steps' losses; the shards' coordinates, specs and sizes to
    assemble them."""
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models.gpt_sharded import ShardedGPT, ShardedGPTConfig
    from hetu_tpu_torch.optim import AdamOptimizer
    torch.manual_seed(0)
    mesh = _mesh(spec["mesh"]) if spec["mesh"] else None
    model = ShardedGPT(ShardedGPTConfig(**spec["cfg"]), mesh)
    params = interop.sharded_params_from_jax(spec["params"], model)
    params0 = {k: _np(v) for k, v in params.items()}
    ids = model.local_batch(spec["ids"])
    labels = model.local_batch(spec["labels"])
    opt = AdamOptimizer(spec["lr"])
    state = opt.init_state(params)
    losses, dropped, grads = [], [], None
    for _ in range(spec["steps"]):
        # make_train_step's step, keeping the first step's gradients
        loss, _, m, g = model.grads(params, ids, labels)
        params, state = opt.update(g, state, params)
        grads = g if grads is None else grads
        losses.append(float(loss))
        dropped.append(float(m["dropped_frac"]))
    return dict(losses=losses, dropped=dropped, coords=dict(model.coords),
                sizes=dict(model.sizes),
                specs={k: tuple(v) for k, v in model.param_specs().items()},
                grads={k: _np(v) for k, v in grads.items()}, params0=params0)
