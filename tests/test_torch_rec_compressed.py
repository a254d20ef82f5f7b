"""examples/rec_compressed.py's training loop in the port (``chip_smoke.py``'s
``compressed_model`` and ``compressed_step_fn``, the loop the card's
``train_compressed`` phase runs) against the example's own ``train_one``
loop in hetu_tpu, on the CPU: the example's synthetic CTR task (4096
samples, 8 fields, vocabulary 5000, dim 8, batches of 128), Adam(5e-3),
5 steps from the same weights (the reference's init, carried across by
``interop``), for the full table, the hash table and DPQ.  Each step's
loss is held within 1e-5 relative of the reference's.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu import ops as jops
from hetu_tpu import optim as joptim
from hetu_tpu_torch import interop, optim

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
example = _load("rec_compressed", ROOT / "examples" / "rec_compressed.py")

VOCAB, DIM, BATCH, STEPS, LR, TOL_LOSS = 5000, 8, 128, 5, 5e-3, 1e-5


def _reference(method, sparse, y):
    """The example's train_one, losses step by step, and the variables it
    started from."""
    fields = sparse.shape[1]
    emb = example.make_table(method, VOCAB, DIM)
    head = example.mlp_tower(fields * DIM, (32,), out_dim=1)
    ke, kh = jax.random.split(jax.random.PRNGKey(0))
    ve, vh = emb.init(ke), head.init(kh)
    start = jax.tree_util.tree_map(np.array, (ve, vh))
    params = {"emb": ve["params"], "head": vh["params"]}
    opt = joptim.AdamOptimizer(LR)
    ostate = opt.init_state(params)

    @jax.jit
    def step(params, ostate, ids, yy):
        def loss_fn(p):
            rows, _ = emb.apply({"params": p["emb"], "state": ve["state"]},
                                ids)
            logit, _ = head.apply({"params": p["head"],
                                   "state": vh["state"]},
                                  rows.reshape(rows.shape[0], -1))
            return jnp.mean(jops.binary_cross_entropy_with_logits(
                logit[:, 0], yy))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, ostate = opt.update(grads, ostate, params)
        return params, ostate, loss

    losses = []
    for it in range(STEPS):
        lo = (it * BATCH) % (sparse.shape[0] - BATCH)
        params, ostate, loss = step(params, ostate,
                                    jnp.asarray(sparse[lo:lo + BATCH]),
                                    jnp.asarray(y[lo:lo + BATCH]))
        losses.append(float(loss))
    return losses, start


@pytest.mark.parametrize("method", ["full", "hash", "dpq"])
def test_example_loop_matches_the_reference(method):
    sparse, y = example.synthetic_ctr(4096, vocab=VOCAB)
    ref_losses, (ve, vh) = _reference(method, sparse, y)
    model = chip_smoke.compressed_model(method, VOCAB, DIM, sparse.shape[1],
                                        torch.Generator().manual_seed(0))
    model["emb"].load_state_dict(interop.variables_from_jax(ve, model["emb"]))
    model["head"].load_state_dict(interop.params_from_jax(vh, model["head"]))
    step = chip_smoke.compressed_step_fn(model, optim.AdamOptimizer(LR))
    losses = []
    for it in range(STEPS):
        lo = (it * BATCH) % (sparse.shape[0] - BATCH)
        losses.append(float(step(torch.tensor(sparse[lo:lo + BATCH]),
                                 torch.tensor(y[lo:lo + BATCH]))))
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL_LOSS)
    assert sum(p.numel() for p in model["emb"].parameters()) == \
        example.param_count(ve["params"])
