"""The embedding memory-compression methods (counterpart of
``hetu_tpu/embedding_compress/layers.py``): 19 methods of the VLDB'24
EmbeddingMemoryCompression tool, grouped as the reference groups them:

  hashing        : HashEmbedding, CompositionalEmbedding (Q-R trick),
                   ROBEEmbedding, DHEEmbedding, DedupEmbedding
  quantization   : DPQEmbedding, MGQEEmbedding, QuantizedEmbedding,
                   ALPTEmbedding
  factorization  : TensorTrainEmbedding (TT-Rec)
  pruning        : PrunedEmbedding (DeepLight), PEPEmbedding,
                   OptEmbedEmbedding, AutoSRHEmbedding
  dim selection  : MixedDimEmbedding (MDE), AutoDimEmbedding,
                   AdaptiveEmbedding
  serving/retrain: SparseEmbedding (ELL), MaskedEmbedding

Each method is a module built from a ``torch.Generator`` (whose device
holds its parameters), called as ``module(ids, train=, generator=)``, and
returns the rows ``[..., dim]``.  Its parameters are float32 masters in
the reference's layouts (DPQ ``logits [N, m, C]``, TT cores ``[r, i, j,
r']``); its state (the reference's ``variables["state"]``) is the buffers
named in ``state_names``, written in place.  The lookups are plain
gathers and products, as in the reference: no kernel of the port runs.

Ids: a negative id counts from the end, as in the reference; where the
reference's ``jnp.take`` would read past a table (and fill the rows with
NaN), the port raises ``IndexError`` (one check, and on the card one
synchronisation, per table read).  The hashed, tiered and factorised
methods map every id into their tables, in both packages.

The discrete choices (DPQ and MGQE codes, ALPT's rounding, the binary
steps of OptEmbed and PEP, the pruning mask) go through one module-level
function each (:data:`DISCRETE_CHOICES`), so a caller can record them in
one pass and replay them in another (``chip_smoke.py``'s float64 gate).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.base import Module
from hetu_tpu_torch.ops.quantize import table_ids, true_div

_P1 = 1_000_000_007  # DHE's hash modulus
_U32 = 0xFFFFFFFF
# 2654435761 = _MUL_HI * 2^16 + _MUL_LO
_MUL_HI, _MUL_LO = 2654435761 >> 16, 2654435761 & 0xFFFF


def _hash(ids, salt: int, mod: int) -> torch.Tensor:
    """The reference's uint32 hash, ``((id * 2654435761 + salt * 40503 +
    1) ^ (h >> 16)) % mod`` with every step wrapping at 2^32 (a negative
    id first wraps to 2^32 + id), as int32.  Computed in int64, the
    multiplier split in two halves so no product passes 2^49."""
    h = torch.as_tensor(ids).long() & _U32
    h = (h * _MUL_LO + (((h * _MUL_HI) & 0xFFFF) << 16)) & _U32
    h = (h + ((salt * 40503 + 1) & _U32)) & _U32
    h = h ^ (h >> 16)
    return (h % mod).to(torch.int32)


def linear_quantile(a, q) -> torch.Tensor:
    """``jnp.quantile(a, q)`` over all of ``a`` (linear interpolation),
    bitwise: the position ``q · (n - 1)`` and the weights in float32 (in
    ``a``'s type for float64), the two order statistics from one sort,
    and ``low · w_low + high · w_high`` rounded as XLA's fused
    multiply-add rounds it (the second product exact, in float64); NaN if
    ``a`` holds one.  Any size (``torch.quantile`` refuses more than 2^24
    elements)."""
    flat = a.reshape(-1)
    dt = torch.promote_types(a.dtype, torch.float32)
    q = torch.as_tensor(q, device=a.device).to(dt)
    n = torch.tensor(float(flat.numel()), dtype=dt, device=a.device)
    pos = q * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    s = torch.sort(flat).values
    last = flat.numel() - 1  # an index past the end reads the last element

    def at(i):
        return s[torch.clamp(i, 0, n - 1).long().clamp(max=last)].to(dt)
    out = (at(high).double() * high_w.double()
           + (at(low) * low_w).double()).to(dt)
    return torch.where(torch.isnan(flat).any(), torch.nan, out).to(a.dtype)


# ---- the discrete choices, one function each (see the module docstring)

def hard_codes(logits):
    """Each subspace's code: the first largest logit."""
    return torch.argmax(logits, dim=-1)


def positive(x):
    """OptEmbed's binary step and PEP's ReLU: ``x > 0``."""
    return x > 0


def magnitude_keep(mag, thresh):
    """The pruning mask: ``|w| >= thresh``."""
    return mag >= thresh


def alpt_round(scaled, noise=None):
    """ALPT's rounding: to nearest even, or ``floor(scaled + 0.5 +
    noise)`` with stochastic noise."""
    if noise is None:
        return torch.round(scaled)
    return torch.floor(scaled + 0.5 + noise)


DISCRETE_CHOICES = ("hard_codes", "positive", "magnitude_keep",
                    "alpt_round")


def _param(init, generator, shape):
    return nn.Parameter(init(generator, shape))


def _full(generator, shape, value):
    return nn.Parameter(torch.full(shape, value, dtype=torch.float32,
                                   device=generator.device))


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _norm(w):
    """``jnp.linalg.norm`` along the last axis: ``sqrt(sum(w * w))``."""
    return torch.sqrt((w * w).sum(-1))


class HashEmbedding(Module):
    """Plain modulo-hash table (reference methods/layers/hash.py)."""

    def __init__(self, num_embeddings: int, dim: int, compress_ratio: float,
                 *, generator: torch.Generator):
        super().__init__()
        self.buckets = max(2, int(num_embeddings * compress_ratio))
        self.dim = dim
        self.table = _param(initializers.normal(stddev=0.01), generator,
                            (self.buckets, dim))

    def forward(self, ids, *, train=False, generator=None):
        return self.table[_hash(ids, 0, self.buckets).long()]


class CompositionalEmbedding(Module):
    """Quotient-remainder compositional (reference compo.py): two small
    tables indexed by id // K and id % K, combined multiplicatively (or
    added, or concatenated)."""

    def __init__(self, num_embeddings: int, dim: int, *, combine: str = "mul",
                 generator: torch.Generator):
        super().__init__()
        self.K = max(2, int(math.isqrt(num_embeddings)) + 1)
        self.nq = (num_embeddings + self.K - 1) // self.K
        self.dim = dim
        self.combine = combine
        init = initializers.normal(stddev=0.05)
        self.q = _param(init, generator, (self.nq, dim))
        self.r = _param(init, generator, (self.K, dim))

    def forward(self, ids, *, train=False, generator=None):
        ids = torch.as_tensor(ids).long()
        eq = self.q[table_ids(torch.div(ids, self.K, rounding_mode="floor"),
                              self.q)]
        er = self.r[torch.remainder(ids, self.K)]
        if self.combine == "mul":
            return eq * er
        if self.combine == "add":
            return eq + er
        return torch.cat([eq, er], dim=-1)


class DPQEmbedding(Module):
    """Differentiable product quantization (reference dpq.py): ids map to
    per-subspace code logits; codebook rows are combined by the one-hot of
    the argmax in the forward and by the softmax in the backward (a
    straight-through estimator)."""

    def __init__(self, num_embeddings: int, dim: int, *, n_codebooks: int = 4,
                 codes: int = 64, generator: torch.Generator):
        super().__init__()
        if dim % n_codebooks:
            raise ValueError(f"dim {dim} is no multiple of n_codebooks "
                             f"{n_codebooks}")
        self.n, self.dim = num_embeddings, dim
        self.m = n_codebooks
        self.codes = codes
        self.sub = dim // n_codebooks
        init = initializers.normal(stddev=0.05)
        self.logits = _param(init, generator,
                             (self.n, self.m, self.codes))
        self.codebooks = _param(init, generator,
                                (self.m, self.codes, self.sub))

    def _combine(self, lg, shape):
        soft = torch.softmax(lg, dim=-1)
        hard = nn.functional.one_hot(hard_codes(lg), self.codes).to(lg.dtype)
        assign = soft + (hard - soft).detach()  # straight-through
        out = torch.einsum("...mc,mcs->...ms", assign, self.codebooks)
        return out.reshape(*shape, self.dim)

    def forward(self, ids, *, train=False, generator=None):
        ids = torch.as_tensor(ids)
        return self._combine(self.logits[table_ids(ids, self.logits)], ids.shape)

    def _serving_logits(self):
        """Logits of the serving argmax; subclasses apply their train-time
        masking here so serving picks the codes of the hard path."""
        return self.logits

    @torch.no_grad()
    def to_serving(self) -> dict:
        """The serving form: narrow-int codes ``[N, m]`` (int8 for up to
        128 codes) and the codebooks — the memory win (the logits are
        train-time only)."""
        code_dtype = torch.int8 if self.codes <= 128 else torch.int16
        codes = hard_codes(self._serving_logits()).to(code_dtype)
        return {"codes": codes, "codebooks": self.codebooks.detach().clone()}

    def serving_lookup(self, serving: dict, ids):
        ids = torch.as_tensor(ids)
        codes = serving["codes"][table_ids(ids, serving["codes"])].long()  # [..., m]
        m = torch.arange(self.m, device=codes.device)
        rows = serving["codebooks"][m, codes]                    # [..., m, s]
        return rows.reshape(*ids.shape, self.dim)


class MGQEEmbedding(DPQEmbedding):
    """Multi-granularity quantization (reference mgqe.py): ids below the
    hot cut (the frequent ones) address the full code space, the others
    only the first ``cold_codes`` codes."""

    def __init__(self, num_embeddings: int, dim: int, *, n_codebooks: int = 4,
                 codes: int = 64, hot_fraction: float = 0.1,
                 cold_codes: int = 16, generator: torch.Generator):
        super().__init__(num_embeddings, dim, n_codebooks=n_codebooks,
                         codes=codes, generator=generator)
        self.hot_cut = max(1, int(num_embeddings * hot_fraction))
        self.cold_codes = cold_codes

    def _masked(self, lg, ids):
        is_hot = (ids < self.hot_cut)[..., None, None]
        code_ok = torch.arange(self.codes, device=lg.device) < self.cold_codes
        return torch.where(is_hot | code_ok, lg, -1e30)

    def forward(self, ids, *, train=False, generator=None):
        ids = torch.as_tensor(ids).long()
        lg = self.logits[table_ids(ids, self.logits)]
        # hot or cold by the id as given: -1 is hot, as in the reference
        return self._combine(self._masked(lg, ids), ids.shape)

    def _serving_logits(self):
        # the cold ids' code mask of forward(): without it the argmax over
        # untrained masked logits could emit codes never used in training
        return self._masked(self.logits, torch.arange(
            self.n, device=self.logits.device))


class TensorTrainEmbedding(Module):
    """TT-Rec factorization (reference tt.py): vocab = prod(i_k), dim =
    prod(j_k); cores ``core<k> [r_{k-1}, i_k, j_k, r_k]`` contracted per
    lookup.  Ids wrap around the mixed radix, as in the reference."""

    def __init__(self, num_embeddings: int, dim: int, *, ranks: int = 8,
                 factors: int = 3, generator: torch.Generator):
        super().__init__()
        self.n, self.dim = num_embeddings, dim
        self.i_facs = self._factorize(num_embeddings, factors)
        self.j_facs = self._factorize(dim, factors)
        self.ranks = [1] + [ranks] * (factors - 1) + [1]
        init = initializers.normal(stddev=0.3)
        for k, (i_f, j_f) in enumerate(zip(self.i_facs, self.j_facs)):
            self.register_parameter(f"core{k}", _param(
                init, generator, (self.ranks[k], i_f, j_f,
                                  self.ranks[k + 1])))

    @staticmethod
    def _factorize(n: int, k: int) -> list:
        base = max(2, int(round(n ** (1.0 / k))))
        facs = [base] * (k - 1)
        last = (n + math.prod(facs) - 1) // math.prod(facs)
        return facs + [max(last, 1)]

    def forward(self, ids, *, train=False, generator=None):
        ids = torch.as_tensor(ids)
        rem = ids.reshape(-1).long()
        out = None
        for k, i_f in enumerate(self.i_facs):
            sub = torch.remainder(rem, i_f)
            rem = torch.div(rem, i_f, rounding_mode="floor")
            core = getattr(self, f"core{k}")[:, sub]   # [r_in, T, j, r_out]
            core = core.movedim(1, 0)                  # [T, r_in, j, r_out]
            if out is None:
                out = core[:, 0]                       # [T, j, r_out]
            else:
                out = torch.einsum("tjr,trks->tjks", out, core)
                out = out.reshape(out.shape[0], -1, out.shape[-1])
        rows = out[..., 0][:, :self.dim]
        return rows.reshape(*ids.shape, self.dim)


class DHEEmbedding(Module):
    """Deep hash embedding (reference dhe.py): k universal hashes give a
    dense feature vector, a small MLP (``w1 [k, hidden]``, ``w2 [hidden,
    dim]``, the reference's ``[in, out]`` layout) maps it to the row; no
    table at all."""

    def __init__(self, num_embeddings: int, dim: int, *, k_hashes: int = 32,
                 hidden: int = 64, generator: torch.Generator):
        super().__init__()
        self.k = k_hashes
        self.dim = dim
        self.hidden = hidden
        init, zeros = initializers.he_normal(), initializers.zeros()
        self.w1 = _param(init, generator, (self.k, hidden))
        self.b1 = _param(zeros, generator, (hidden,))
        self.w2 = _param(init, generator, (hidden, dim))
        self.b2 = _param(zeros, generator, (dim,))

    def forward(self, ids, *, train=False, generator=None):
        dt = self.w1.dtype
        feats = torch.stack([true_div(_hash(ids, s, _P1).to(dt), _P1)
                             for s in range(self.k)], dim=-1)
        feats = (feats - 0.5) * 3.46  # ~unit variance
        h = ops.gelu(feats @ self.w1 + self.b1)
        return h @ self.w2 + self.b2


class ROBEEmbedding(Module):
    """Random offset block embedding (reference robe.py): rows are chunks
    of one shared weight array addressed by hashed offsets."""

    def __init__(self, num_embeddings: int, dim: int, compress_ratio: float,
                 *, chunk: int = 8, generator: torch.Generator):
        super().__init__()
        self.size = max(dim, int(num_embeddings * dim * compress_ratio))
        self.dim = dim
        self.chunk = chunk
        self.n_chunks = (dim + chunk - 1) // chunk
        self.array = _param(initializers.normal(stddev=0.01), generator,
                            (self.size,))

    def forward(self, ids, *, train=False, generator=None):
        span = torch.arange(self.chunk, device=self.array.device)
        parts = []
        for c in range(self.n_chunks):
            off = _hash(ids, c + 1, max(self.size - self.chunk, 1)).long()
            parts.append(self.array[table_ids(off[..., None] + span,
                                              self.array)])
        return torch.cat(parts, dim=-1)[..., :self.dim]


class QuantizedEmbedding(Module):
    """int8-storage embedding (reference quantize.py): rows stored
    quantized with a per-row scale (buffers ``q``, ``scale``), dequantized
    at the gather.  Not trainable: the serving form (the reference's
    switchinference stage).  Built from ``table`` when given, else from a
    table drawn normal(0.01) from ``generator``, as the reference's
    ``init``."""

    state_names = ("q", "scale")

    def __init__(self, num_embeddings: int, dim: int, *, bits: int = 8,
                 generator: Optional[torch.Generator] = None, table=None):
        super().__init__()
        self.n, self.dim = num_embeddings, dim
        self.bits = bits
        if table is None:
            table = initializers.normal(stddev=0.01)(generator,
                                                     (num_embeddings, dim))
        q, scale = self.from_table(table, bits)
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    def forward(self, ids, *, train=False, generator=None):
        return ops.quantize_embedding_lookup(self.q, self.scale, ids)

    @staticmethod
    @torch.no_grad()
    def from_table(table, bits: int = 8):
        """``(q int8 [N, D], scale [N])``: each row over its largest
        magnitude (at least 1e-8) / qmax, rounded to nearest even."""
        qmax = 2 ** (bits - 1) - 1
        scale = true_div(torch.clamp(table.abs().amax(dim=1), min=1e-8),
                         qmax)
        q = torch.clamp(torch.round(table / scale[:, None]), -qmax - 1,
                        qmax).to(torch.int8)
        return q, scale


class ALPTEmbedding(Module):
    """Adaptive low-precision training (reference alpt.py): rows with a
    learned per-row ``log_scale``, rounded to ``bits`` in the forward
    (stochastically when training with a generator), the rounding passed
    straight through in the backward."""

    def __init__(self, num_embeddings: int, dim: int, *, bits: int = 8,
                 generator: torch.Generator):
        super().__init__()
        self.n, self.dim, self.bits = num_embeddings, dim, bits
        self.w = _param(initializers.normal(stddev=0.01), generator,
                        (self.n, dim))
        self.log_scale = _full(generator, (self.n,), -5.0)

    def forward(self, ids, *, train=False, generator=None):
        idx = table_ids(ids, self.w)
        rows = self.w[idx]
        scale = torch.exp(self.log_scale[idx])[..., None]
        qmax = 2 ** (self.bits - 1) - 1
        scaled = rows / scale
        noise = None
        if train and generator is not None:
            noise = torch.rand(scaled.shape, generator=generator,
                               device=scaled.device,
                               dtype=scaled.dtype) - 0.5
        rounded = torch.clamp(alpt_round(scaled, noise), -qmax - 1, qmax)
        deq = rounded * scale
        # straight-through: the forward takes the quantized value
        return scaled * scale + (deq - scaled * scale).detach()


class PrunedEmbedding(Module):
    """DeepLight-style magnitude pruning (reference prune.py): the looked-up
    rows' elements below the ``rate`` quantile of their magnitudes are
    zeroed; ``rate`` is a buffer a schedule sets
    (:func:`~hetu_tpu_torch.embedding_compress.scheduler.prune_rate_setter`)."""

    state_names = ("rate",)

    def __init__(self, num_embeddings: int, dim: int, *, rate: float = 0.9,
                 generator: torch.Generator):
        super().__init__()
        self.n, self.dim = num_embeddings, dim
        self.w = _param(initializers.normal(stddev=0.01), generator,
                        (self.n, dim))
        self.register_buffer("rate", torch.tensor(
            rate, dtype=torch.float32, device=generator.device))

    def forward(self, ids, *, train=False, generator=None):
        rows = self.w[table_ids(ids, self.w)]
        mag = rows.abs()
        thresh = linear_quantile(mag.detach(), self.rate)
        return torch.where(magnitude_keep(mag, thresh), rows,
                           rows.new_zeros(()))


class PEPEmbedding(Module):
    """Plug-in embedding pruning (reference pep.py): learnable per-element
    soft thresholds ``g``; ``w_eff = sign(w) * relu(|w| - sigmoid(g))``."""

    def __init__(self, num_embeddings: int, dim: int, *,
                 init_threshold: float = -8.0, generator: torch.Generator):
        super().__init__()
        self.n, self.dim = num_embeddings, dim
        self.init_threshold = init_threshold
        self.w = _param(initializers.normal(stddev=0.01), generator,
                        (self.n, dim))
        self.g = _full(generator, (self.n, dim), init_threshold)

    def forward(self, ids, *, train=False, generator=None):
        idx = table_ids(ids, self.w)
        w, g = self.w[idx], self.g[idx]
        x = w.abs() - torch.sigmoid(g)
        # jax.nn.relu: its derivative at 0 is 0
        return torch.sign(w) * torch.where(positive(x), x, x.new_zeros(()))


class OptEmbedEmbedding(Module):
    """OptEmbed (reference optembed.py): a learnable per-row threshold
    ``t``; a row is kept while its norm exceeds ``softplus(t)``, a binary
    step with a straight-through sigmoid gradient."""

    def __init__(self, num_embeddings: int, dim: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.n, self.dim = num_embeddings, dim
        self.w = _param(initializers.normal(stddev=0.01), generator,
                        (self.n, dim))
        # softplus(-6) ~ 0: every row starts kept and gradients flow
        self.t = _full(generator, (self.n,), -6.0)

    def forward(self, ids, *, train=False, generator=None):
        idx = table_ids(ids, self.w)
        w, t = self.w[idx], self.t[idx]
        score = _norm(w) - _softplus(t)
        hard = positive(score).to(w.dtype)
        soft = torch.sigmoid(score * 10.0)
        mask = soft + (hard - soft).detach()
        return w * mask[..., None]


class AutoSRHEmbedding(Module):
    """AutoSRH (reference autosrh.py): per-element relevance gates
    ``alpha`` learned jointly, pruned by magnitude at deploy time
    (:func:`autosrh_to_retrain`)."""

    def __init__(self, num_embeddings: int, dim: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.n, self.dim = num_embeddings, dim
        self.w = _param(initializers.normal(stddev=0.01), generator,
                        (self.n, dim))
        self.alpha = _full(generator, (self.n, dim), 1.0)

    def forward(self, ids, *, train=False, generator=None):
        idx = table_ids(ids, self.w)
        return self.w[idx] * self.alpha[idx]


class MixedDimEmbedding(Module):
    """Mixed-dimension embedding (reference mde.py): id ranges (frequency
    tiers) get tables ``t<i>`` of their own dims, projected up to ``dim``
    by ``p<i>``.  An id in no tier gives a zero row, in both packages."""

    def __init__(self, num_embeddings: int, dim: int, *,
                 tier_fractions: Sequence[float] = (0.1, 0.9),
                 tier_dims: Sequence[int] = None,
                 generator: torch.Generator):
        super().__init__()
        self.n, self.dim = num_embeddings, dim
        tier_dims = tier_dims or [dim, max(2, dim // 4)]
        self.tiers = []
        start = 0
        for frac, d in zip(tier_fractions, tier_dims):
            cnt = max(1, int(num_embeddings * frac))
            self.tiers.append((start, min(start + cnt, num_embeddings), d))
            start += cnt
        if start < num_embeddings:  # remainder into last tier
            s, e, d = self.tiers[-1]
            self.tiers[-1] = (s, num_embeddings, d)
        init = initializers.normal(stddev=0.01)
        for i, (s, e, d) in enumerate(self.tiers):
            self.register_parameter(f"t{i}", _param(init, generator,
                                                    (e - s, d)))
            if d != dim:
                self.register_parameter(f"p{i}", _param(init, generator,
                                                        (d, dim)))

    def forward(self, ids, *, train=False, generator=None):
        ids = torch.as_tensor(ids).long()
        out = None
        for i, (s, e, d) in enumerate(self.tiers):
            table = getattr(self, f"t{i}")
            if out is None:
                out = table.new_zeros((*ids.shape, self.dim))
            in_tier = (ids >= s) & (ids < e)
            rows = table[torch.clamp(ids - s, 0, e - s - 1)]
            if d != self.dim:
                rows = rows @ getattr(self, f"p{i}")
            out = torch.where(in_tier[..., None], rows, out)
        return out


class AutoDimEmbedding(Module):
    """AutoDim (reference autodim.py): differentiable dim selection —
    every candidate dim has a table ``t<i>`` and a projection ``p<i>``; a
    learned softmax over ``arch`` mixes them."""

    def __init__(self, num_embeddings: int, dim: int, *,
                 candidate_dims: Sequence[int] = None,
                 generator: torch.Generator):
        super().__init__()
        self.n, self.dim = num_embeddings, dim
        self.cands = list(candidate_dims or [dim, dim // 2, dim // 4])
        self.arch = _full(generator, (len(self.cands),), 0.0)
        init = initializers.normal(stddev=0.01)
        for i, d in enumerate(self.cands):
            self.register_parameter(f"t{i}", _param(init, generator,
                                                    (self.n, d)))
            self.register_parameter(f"p{i}", _param(init, generator,
                                                    (d, dim)))

    def forward(self, ids, *, train=False, generator=None):
        idx = table_ids(ids, self.t0)
        w = torch.softmax(self.arch, dim=0)
        out = None
        for i in range(len(self.cands)):
            term = w[i] * (getattr(self, f"t{i}")[idx]
                           @ getattr(self, f"p{i}"))
            out = term if out is None else out + term
        return out

    def selected_dim(self) -> int:
        return self.cands[int(torch.argmax(self.arch))]


class DedupEmbedding(Module):
    """Dedup (reference dedup.py): an index-indirection buffer ``remap``
    maps ids to shared physical rows (e.g. after near-duplicate
    clustering); it starts as a hash of the ids."""

    state_names = ("remap",)

    def __init__(self, num_embeddings: int, dim: int, compress_ratio: float,
                 *, generator: torch.Generator):
        super().__init__()
        self.n = num_embeddings
        self.phys = max(2, int(num_embeddings * compress_ratio))
        self.dim = dim
        self.table = _param(initializers.normal(stddev=0.01), generator,
                            (self.phys, dim))
        self.register_buffer("remap", _hash(torch.arange(
            self.n, device=generator.device), 7, self.phys))

    def set_remap(self, remap) -> "DedupEmbedding":
        self.remap = torch.as_tensor(remap, dtype=torch.int32,
                                     device=self.table.device)
        return self

    def forward(self, ids, *, train=False, generator=None):
        phys = self.remap[table_ids(ids, self.remap)]
        return self.table[table_ids(phys, self.table)]


class SparseEmbedding(Module):
    """Sparse-format serving embedding (reference sparse.py: CSR inference
    after pruning), in ELL form so lookups stay fixed-shape: buffers
    ``values [N, max_nnz]`` and ``cols [N, max_nnz]`` int32, -1 padding.
    Build it from a pruned table with :meth:`from_dense`."""

    state_names = ("values", "cols")

    def __init__(self, num_embeddings: int, dim: int, *, max_nnz: int,
                 generator: torch.Generator):
        super().__init__()
        self.n, self.dim, self.max_nnz = num_embeddings, dim, max_nnz
        dev = generator.device
        self.register_buffer("values", torch.zeros(
            (num_embeddings, max_nnz), device=dev))
        self.register_buffer("cols", torch.full(
            (num_embeddings, max_nnz), -1, dtype=torch.int32, device=dev))

    @staticmethod
    @torch.no_grad()
    def from_dense(table, max_nnz: int) -> "SparseEmbedding":
        """The ELL form of a (pruned) dense table, on its device: each
        row's ``max_nnz`` largest magnitudes, zeros dropped (the order of
        tied columns is unspecified, as ``lax.top_k``'s differs)."""
        n, dim = table.shape
        mag = table.abs()
        _, cols = torch.topk(mag, max_nnz, dim=1)
        vals = torch.gather(table, 1, cols)
        keep = torch.gather(mag, 1, cols) > 0
        m = SparseEmbedding(n, dim, max_nnz=max_nnz,
                            generator=torch.Generator(device=table.device))
        m.values.copy_(torch.where(keep, vals, 0.0))
        m.cols.copy_(torch.where(keep, cols, -1))
        return m

    def forward(self, ids, *, train=False, generator=None):
        idx = table_ids(ids, self.values)
        vals = self.values[idx]                          # [..., max_nnz]
        cols = self.cols[idx].long()
        safe = torch.where(cols >= 0, cols, 0)
        contrib = torch.where(cols >= 0, vals, 0.0)
        # scatter the nnz entries into their dense positions
        one_hot = nn.functional.one_hot(safe, self.dim).to(vals.dtype)
        return torch.einsum("...k,...kd->...d", contrib, one_hot)


class MaskedEmbedding(Module):
    """Finetuning module of the retrain conversions: the lookup applies
    the FROZEN ``mask`` buffer, so masked positions give zero output AND
    zero gradient, for any number of optimizer steps (the reference's
    *Retrain modules do the same).  Starts as zeros under an all-ones
    mask; the converters fill it."""

    state_names = ("mask",)

    def __init__(self, num_embeddings: int, dim: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.n, self.dim = num_embeddings, dim
        self.w = _full(generator, (self.n, dim), 0.0)
        self.register_buffer("mask", torch.ones(
            (self.n, dim), device=generator.device))

    def forward(self, ids, *, train=False, generator=None):
        idx = table_ids(ids, self.w)
        return self.w[idx] * self.mask[idx]


class RetrainForm(Module):
    """A retrain stage's variables as a module: the parameters and state
    buffers that the reference's converters return in a dict, under its
    names.  It defines no lookup, as the reference's converters give
    none."""

    def __init__(self, params: dict, state: dict):
        super().__init__()
        for name, p in params.items():
            self.register_parameter(name, nn.Parameter(p.detach().clone()))
        self.state_names = ()
        for name, s in state.items():
            self.add_state(name, s)

    def add_state(self, name: str, value) -> None:
        self.register_buffer(name, torch.as_tensor(value))
        self.state_names = (*self.state_names, name)


def _masked_copy(like, w, mask) -> MaskedEmbedding:
    m = MaskedEmbedding(like.n, like.dim,
                        generator=torch.Generator(device=w.device))
    m.w.data.copy_(w)
    m.mask.copy_(mask)
    return m


@torch.no_grad()
def pep_to_retrain(pep: PEPEmbedding) -> MaskedEmbedding:
    """PEPRetrainEmbedding analog: freeze the learned sparsity pattern,
    ``|w| > sigmoid(g)``, into a :class:`MaskedEmbedding` (weights
    masked)."""
    w = pep.w
    mask = (w.abs() > torch.sigmoid(pep.g)).to(w.dtype)
    return _masked_copy(pep, w * mask, mask)


@torch.no_grad()
def autosrh_to_retrain(module: AutoSRHEmbedding,
                       keep_fraction: float = 0.5) -> MaskedEmbedding:
    """AutoSrhRetrainEmbedding analog: prune the gates below the
    ``1 - keep_fraction`` quantile of ``|alpha|``; the retrain weights
    start from the trained forward's ``w * alpha``, masked."""
    a = module.alpha.abs()
    thresh = linear_quantile(a, 1.0 - keep_fraction)
    mask = (a >= thresh).to(module.w.dtype)
    return _masked_copy(module, module.w * module.alpha * mask, mask)


@torch.no_grad()
def autodim_to_retrain(module: AutoDimEmbedding) -> RetrainForm:
    """AutoDimRetrainEmbedding analog: only the winning candidate's table
    ``t`` and projection ``p`` (by :meth:`AutoDimEmbedding.selected_dim`),
    and its ``dim``."""
    dim = module.selected_dim()
    best = module.cands.index(dim)
    return RetrainForm({"t": getattr(module, f"t{best}"),
                        "p": getattr(module, f"p{best}")},
                       {"dim": torch.tensor(dim, device=module.arch.device)})


@torch.no_grad()
def optembed_row_pruned(module: OptEmbedEmbedding) -> RetrainForm:
    """OptEmbeddingAfterRowPruning analog: the rows whose norm does not
    exceed ``softplus(t)`` zeroed, and that ``row_mask`` (the compact
    remap happens host-side when the smaller table is materialised)."""
    w = module.w
    mask = (_norm(w) - _softplus(module.t) > 0).to(w.dtype)
    return RetrainForm({"w": w * mask[:, None]}, {"row_mask": mask})


class AdaptiveEmbedding(MixedDimEmbedding):
    """Adaptive embedding (reference adapt.py, Transformer-XL style): the
    tiered mixed-dim scheme with tiers of 10 %, 40 %, ... of the ids and
    dims divided by ``div`` per tier."""

    def __init__(self, num_embeddings: int, dim: int, *, n_tiers: int = 3,
                 div: int = 4, generator: torch.Generator):
        fracs, dims = [], []
        rem = 1.0
        for t in range(n_tiers):
            f = min(0.1 * (4 ** t), rem)
            fracs.append(f)
            dims.append(max(2, dim // (div ** t)))
            rem -= f
        if rem > 0:
            fracs[-1] += rem
        super().__init__(num_embeddings, dim, tier_fractions=fracs,
                         tier_dims=dims, generator=generator)
