"""AdamW's bound on how far two runs' parameters and slots drift apart when
their gradients differ by at most a known gap, shared by the executor
parity tests of ``tests/test_torch_gpt_train.py`` and
``tests/test_torch_moe.py``; derived in the module docstring of the latter.
Each test chooses its gradient gap: per element or per leaf's largest."""

import numpy as np


def flat(t, path=()):
    """(path, f32 array) for every leaf of the nested dict ``t``."""
    if isinstance(t, dict):
        for k, v in t.items():
            yield from flat(v, path + (k,))
    else:
        yield path, np.asarray(t, np.float32)


def get(t, path):
    for k in path:
        t = t[k]
    return np.asarray(t, np.float32)


def adamw_atol(deltas, grads, lr, eps, beta2=0.999):
    """The absolute tolerances of a parameter and its m and v slots after
    AdamW steps of ``lr`` and ``eps`` whose gradients differ by at most
    ``deltas`` (one bound a step, gradients as large as ``grads``): the
    parameter within lr / eps * sum_t delta_t, m within max_t delta_t and v
    within (1 - b2) sum_t (2 G_t + delta_t) delta_t."""
    return {"params": lr / eps * np.sum(deltas, axis=0),
            "m": np.max(deltas, axis=0),
            "v": (1 - beta2) * np.sum([(2 * g + d) * d for g, d in zip(
                grads, deltas)], axis=0)}
