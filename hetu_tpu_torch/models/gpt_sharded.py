"""ShardedGPT: the fully sharded GPT-MoE training step (counterpart of
``hetu_tpu/models/gpt_sharded.py``).

One rank a device of a ``make_mesh`` mesh; every rank runs the same local
step on its shards, with every collective written out, as the reference's
``shard_map`` (all axes manual) does:

  dp -- the batch split, the gradients summed over it;
  pp -- GPipe's tick loop over the block stack (:mod:`..parallel.pipeline`),
        activations sent to the next stage each tick;
  sp -- ring attention over the sequence (:mod:`..parallel.ring_attention`,
        on the flash kernels);
  tp -- Megatron's column split of QKV and of the experts' FFN, the row
        split of the output projections with a ``psum``, the vocabulary
        split of the embedding and of the cross-entropy;
  ep -- the experts split, tokens sent to their experts' ranks by
        all-to-all (:func:`~hetu_tpu_torch.layers.moe.expert_parallel`,
        through the gather kernels; the gate on the top-k kernel).

Gradients are the global program's, as the reference's ``shard_map``
differentiates it: every collective's gradient is its transpose
(:mod:`~hetu_tpu_torch.parallel.collectives`); a parameter enters through
``shard_map_input`` over the axes its spec does not split (its gradient
summed over them: the split work adds up, and the duplicated work, whose
cotangents the loss's ``shard_map_output`` divided among the ranks, adds up
to one copy); so ``loss.backward()`` on every rank gives each rank the
gradient of its own shards.

The reference's dense einsum dispatch is replaced by the gather route of
:class:`~hetu_tpu_torch.layers.moe.MoELayer`; both are built from one
capacity assignment and compute the same function.

Constraints: layers % pp == 0, heads % tp == 0, seq % sp == 0,
batch % (dp * n_microbatches) == 0, experts % ep == 0, ffn % tp == 0.
The parameters are one flat dict named by the reference's tree paths
(``blocks.qkv_w``), blocks stacked ``[L, ...]`` as there.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from hetu_tpu_torch import init as initializers
from hetu_tpu_torch import ops
from hetu_tpu_torch.layers.moe import expert_matmul, expert_parallel
from hetu_tpu_torch.ops.cuda_kernels.embedding import topk_gating
from hetu_tpu_torch.parallel import collectives
from hetu_tpu_torch.parallel.mesh import DEFAULT_AXIS_ORDER
from hetu_tpu_torch.parallel.pipeline import checkpointed, pipeline_ticks
from hetu_tpu_torch.parallel.ring_attention import ring_flash
from hetu_tpu_torch.parallel.spec import P

AXES = DEFAULT_AXIS_ORDER  # pp, dp, sp, ep, tp


@dataclass
class ShardedGPTConfig:
    vocab_size: int = 512
    hidden_size: int = 128
    num_layers: int = 4
    num_heads: int = 8
    ffn_size: int = 256
    num_experts: int = 4
    top_k: int = 2
    capacity_factor: float = 2.0
    max_position: int = 128
    n_microbatches: int = 2
    aux_weight: float = 1e-2
    dtype: torch.dtype = torch.float32
    vocab_parallel: bool = True   # Megatron vocab-split embedding + CE
    remat: bool = False           # recompute blocks (activation memory)


def _shard(x, spec: P, sizes: dict, coords: dict):
    """This rank's piece of ``x`` under ``spec``."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n, i = sizes[entry], coords[entry]
        size = x.shape[d] // n
        x = x.narrow(d, i * size, size)
    return x


def unmentioned(spec: P) -> tuple:
    """The mesh axes a spec does not split (a parameter's replicas)."""
    return tuple(a for a in AXES if a not in tuple(spec))


class ShardedGPT:
    """The sharded step on ``mesh`` (``None``: one rank, every axis 1)."""

    def __init__(self, config: ShardedGPTConfig, mesh=None):
        self.c = config
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
        self.sizes = {a: (mesh.size(names.index(a)) if a in names else 1)
                      for a in AXES}
        self.coords = {a: (mesh.get_local_rank(a) if a in names else 0)
                       for a in AXES}
        self.dp, self.pp, self.sp, self.tp, self.ep = (
            self.sizes[a] for a in ("dp", "pp", "sp", "tp", "ep"))
        c = config
        for what, a, b in (("layers", c.num_layers, self.pp),
                           ("heads", c.num_heads, self.tp),
                           ("ffn", c.ffn_size, self.tp),
                           ("experts", c.num_experts, self.ep)):
            if a % b:
                raise ValueError(f"{what} {a} do not split over {b} ranks")
        self.vocab_parallel = c.vocab_parallel and \
            c.vocab_size % self.tp == 0
        # every group the step uses, made now in one order on every rank
        self._groups = {}
        for axes in [(a,) for a in AXES] + [("dp", "sp")] + [
                unmentioned(s) for s in self.param_specs().values()]:
            self._group(axes)

    def _group(self, axes):
        """The process group of ``axes`` (their sizes > 1), None if they
        hold one rank."""
        keep = tuple(a for a in AXES if a in axes and self.sizes[a] > 1)
        if not keep:
            return None
        if keep not in self._groups:
            self._groups[keep] = collectives.axis_group(
                keep[0] if len(keep) == 1 else keep, self.mesh)
        return self._groups[keep]

    def _psum(self, x, axes):
        g = self._group(axes)
        return x if g is None else collectives.psum(x, g)

    def _pmean(self, x, axes):
        n = 1
        for a in axes:
            n *= self.sizes[a]
        return self._psum(x, axes) / n

    def _pmax_nograd(self, x, axes):
        """The max over ``axes`` of a value with no gradient."""
        g = self._group(axes)
        if g is None:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=g)
        return y

    # ---- parameters ----
    def init(self, generator: torch.Generator) -> dict:
        """The whole parameters, f32 on the generator's device, in the
        reference's shapes."""
        c = self.c
        D, Fz, E, L, V = (c.hidden_size, c.ffn_size, c.num_experts,
                          c.num_layers, c.vocab_size)
        wi = initializers.normal(stddev=0.02)
        hi = initializers.he_normal()
        zeros, ones = initializers.zeros(), initializers.ones()

        def stack(fn, shape):
            return torch.stack([fn(generator, shape) for _ in range(L)])
        return {
            "tok_emb": wi(generator, (V, D)),
            "pos_emb": wi(generator, (c.max_position, D)),
            "blocks.ln1_scale": ones(generator, (L, D)),
            "blocks.ln1_bias": zeros(generator, (L, D)),
            "blocks.qkv_w": stack(wi, (D, 3 * D)),
            "blocks.qkv_b": zeros(generator, (L, 3 * D)),
            "blocks.out_w": stack(wi, (D, D)),
            "blocks.out_b": zeros(generator, (L, D)),
            "blocks.ln2_scale": ones(generator, (L, D)),
            "blocks.ln2_bias": zeros(generator, (L, D)),
            "blocks.gate_w": stack(wi, (D, E)),
            "blocks.w1": stack(hi, (E, D, Fz)),
            "blocks.b1": zeros(generator, (L, E, Fz)),
            "blocks.w2": stack(hi, (E, Fz, D)),
            "blocks.b2": zeros(generator, (L, E, D)),
            "ln_f_scale": ones(generator, (D,)),
            "ln_f_bias": zeros(generator, (D,)),
        }

    def param_specs(self) -> dict:
        """The reference's partition specs, by parameter name."""
        pp, tp, ep = "pp", "tp", "ep"
        return {
            # vocab-parallel: the table's rows split over tp
            "tok_emb": P(tp) if self.vocab_parallel else P(),
            "pos_emb": P(),
            "blocks.ln1_scale": P(pp), "blocks.ln1_bias": P(pp),
            "blocks.qkv_w": P(pp, None, tp), "blocks.qkv_b": P(pp, tp),
            "blocks.out_w": P(pp, tp, None), "blocks.out_b": P(pp),
            "blocks.ln2_scale": P(pp), "blocks.ln2_bias": P(pp),
            "blocks.gate_w": P(pp),
            "blocks.w1": P(pp, ep, None, tp), "blocks.b1": P(pp, ep, tp),
            "blocks.w2": P(pp, ep, tp, None), "blocks.b2": P(pp, ep),
            "ln_f_scale": P(), "ln_f_bias": P(),
        }

    def place(self, params: dict, device=None) -> dict:
        """This rank's shards of the whole ``params`` (every rank holds
        them), as fresh leaf tensors that take gradients."""
        specs = self.param_specs()
        out = {}
        for k, v in params.items():
            x = _shard(torch.as_tensor(v), specs[k], self.sizes, self.coords)
            x = x.to(device) if device is not None else x
            out[k] = x.detach().clone().requires_grad_(True)
        return out

    def data_sharding(self) -> P:
        return P("dp", "sp")

    def local_batch(self, x):
        """This rank's ``[B/dp, S/sp]`` piece of a whole ``[B, S]``
        batch."""
        return _shard(torch.as_tensor(x), self.data_sharding(), self.sizes,
                      self.coords)

    # ---- local (per-rank) computation ----
    def _attention(self, p, h):
        """h ``[mb, s_loc, D]``, whole over tp: Megatron's column and row
        split around ring attention over sp."""
        c = self.c
        mb, s_loc, D = h.shape
        h_loc = c.num_heads // self.tp
        hd = D // c.num_heads
        x = ops.layer_norm(h, p["ln1_scale"], p["ln1_bias"])
        dt = c.dtype
        qkv = x.to(dt) @ p["qkv_w"].to(dt) + p["qkv_b"]
        # head-major fused QKV (H, 3, hd): the tp column split hands every
        # rank whole (q, k, v) triples of its heads
        qkv = qkv.reshape(mb, s_loc, h_loc, 3, hd)
        q, k, v = (qkv[:, :, :, i].movedim(1, 2) for i in range(3))
        o = ring_flash(q, k, v, self._group(("sp",)), causal=True,
                       scale=hd ** -0.5)
        o = o.movedim(1, 2).reshape(mb, s_loc, h_loc * hd)
        y = o.to(dt) @ p["out_w"].to(dt)
        y = self._psum(y, ("tp",)) + p["out_b"]
        return h + y

    def _experts(self, p):
        """The local experts, their F split over tp: ``xe [E/ep, C', D]``
        → ``[E/ep, C', D]`` f32."""
        dt = self.c.dtype

        def run(xe):
            h1 = expert_matmul(xe.to(dt), p["w1"].to(dt)) + p["b1"][:, None]
            h1 = ops.gelu(h1)
            ye = expert_matmul(h1.to(dt), p["w2"].to(dt))
            return self._psum(ye, ("tp",)) + p["b2"][:, None]
        return run

    def _moe_ffn(self, p, h):
        """MoE FFN: all-to-all over ep, the experts' F split over tp.
        Returns ``(h, aux, dropped routes)``."""
        c = self.c
        mb, s_loc, D = h.shape
        E = c.num_experts
        x = ops.layer_norm(h, p["ln2_scale"], p["ln2_bias"])
        tokens = x.reshape(-1, D)
        t = tokens.shape[0]
        capacity = max(1, int(c.capacity_factor * t * c.top_k / E))
        logits = tokens.float() @ p["gate_w"]
        gates, idx = topk_gating(logits, c.top_k)
        # GShard's load-balancing loss, its statistics over the GLOBAL
        # batch, so that the sharded loss is the single device's
        probs = torch.softmax(logits, dim=-1)
        me = self._pmean(probs.mean(dim=0), ("dp", "sp"))
        ce = self._pmean(F.one_hot(idx[:, 0].long(), E).float().mean(dim=0),
                         ("dp", "sp"))
        aux = c.aux_weight * E * (me * ce).sum()
        out, dropped = expert_parallel(tokens, gates, idx, E, capacity,
                                       self._experts(p),
                                       self._group(("ep",)))
        return h + out.reshape(mb, s_loc, D), aux, dropped.float()

    def _block(self, p, h):
        return self._moe_ffn(p, self._attention(p, h))

    def _embed(self, params, ids):
        s_loc = ids.shape[1]
        emb = params["tok_emb"]
        if self.vocab_parallel:
            v_loc = emb.shape[0]
            rel = ids.long() - self.coords["tp"] * v_loc
            in_rng = (rel >= 0) & (rel < v_loc)
            h = emb[rel.clamp(0, v_loc - 1)]
            h = torch.where(in_rng[..., None], h, torch.zeros_like(h))
            h = self._psum(h, ("tp",))   # the whole embedding
        else:
            h = ops.embedding_lookup(emb, ids)
        pos = self.coords["sp"] * s_loc + torch.arange(s_loc,
                                                       device=ids.device)
        return h + params["pos_emb"][pos][None]

    def _token_losses(self, params, hs, labels):
        """Per-token CE ``[b, s]`` of the tied head (0 at label -1)."""
        emb = params["tok_emb"]
        if not self.vocab_parallel:
            logits = hs @ emb.t()
            return ops.softmax_cross_entropy_sparse(logits, labels,
                                                    ignored_index=-1)
        # vocab-parallel CE: each tp rank scores its vocabulary slice; the
        # normaliser and the target logit assemble over tp, so the [b, s,
        # V] logits never exist on one rank
        v_loc = emb.shape[0]
        logits = hs @ emb.t()                              # [b, s, V/tp]
        # the max is for stability only: no gradient through it
        m = self._pmax_nograd(logits.detach().amax(dim=-1), ("tp",))
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        lse = torch.log(self._psum(se, ("tp",))) + m
        rel = labels.long() - self.coords["tp"] * v_loc
        in_rng = (rel >= 0) & (rel < v_loc)
        tgt = logits.gather(-1, rel.clamp(0, v_loc - 1)[..., None])[..., 0]
        tgt = self._psum(torch.where(in_rng, tgt, torch.zeros_like(tgt)),
                         ("tp",))
        return torch.where(labels == -1, torch.zeros_like(lse), lse - tgt)

    def _local_step(self, params, ids, labels):
        """The local program of every rank.  ``ids``, ``labels``: ``[b_loc,
        s_loc]`` (split over dp x sp).  Returns ``(loss + aux, aux,
        dropped, routes)``, the first two the same on every rank."""
        c = self.c
        M = c.n_microbatches
        b_loc, s_loc = ids.shape
        if b_loc % M:
            raise ValueError(f"local batch {b_loc} not divisible by {M} "
                             f"microbatches")
        mb = b_loc // M
        D = c.hidden_size
        xs = self._embed(params, ids).reshape(M, mb, s_loc, D)

        blocks = {k[len("blocks."):]: v for k, v in params.items()
                  if k.startswith("blocks.")}
        n_per = blocks["ln1_scale"].shape[0]
        block = checkpointed(self._block) if c.remat else self._block
        routes = float(mb * s_loc * c.top_k * n_per)

        def stage_fn(h):
            aux = dropped = torch.zeros((), device=h.device)
            for i in range(n_per):
                h, a, d = block({k: v[i] for k, v in blocks.items()}, h)
                aux, dropped = aux + a, dropped + d
            return h, (aux, dropped, torch.full((), routes,
                                                device=h.device))

        outs, (aux_total, dropped, n_routes) = pipeline_ticks(
            stage_fn, xs, group=self._group(("pp",)), n_stages=self.pp)

        # head + loss on the last stage (tied weights)
        hs = outs.reshape(b_loc, s_loc, D).float()
        hs = ops.layer_norm(hs, params["ln_f_scale"], params["ln_f_bias"])
        per_tok = self._token_losses(params, hs, labels)
        # global sum / global count (not a mean of shard ratios): the
        # sharded loss is the single device's
        num = self._psum(per_tok.sum(), ("dp", "sp"))
        den = self._psum((labels != -1).sum().float(), ("dp", "sp"))
        local_loss = num / den.clamp_min(1.0)
        last = torch.tensor(self.coords["pp"] == self.pp - 1,
                            device=ids.device)
        loss = self._psum(torch.where(last, local_loss,
                                      torch.zeros_like(local_loss)), ("pp",))
        # the psum over pp sums DISTINCT layer groups (not replicas)
        aux_mean = self._pmean(self._psum(aux_total, ("pp",)) / M,
                               ("dp", "sp"))
        return loss + aux_mean, aux_mean, dropped, n_routes

    # ---- public API ----
    def loss_fn(self):
        """``f(params, ids, labels) -> (loss, aux, metrics)`` on this
        rank's shards (:meth:`place`, :meth:`local_batch`): ``loss``
        (with the aux loss) and ``aux`` are the global batch's, the same
        on every rank; ``loss.backward()`` gives each rank the gradient of
        its shards.  ``metrics["dropped_frac"]``: the share of this rank's
        routes dropped past capacity."""
        specs = self.param_specs()

        def enter(k, v):  # a parameter, whole over the axes it leaves out
            g = self._group(unmentioned(specs[k]))
            return v if g is None else collectives.shard_map_input(v, g)

        def f(params, ids, labels):
            loss, aux, dropped, routes = self._local_step(
                {k: enter(k, v) for k, v in params.items()}, ids, labels)
            if self.mesh is not None:
                # the loss every rank computes counts once in the global
                # program
                loss = collectives.shard_map_output(loss, AXES,
                                                    mesh=self.mesh)
            return loss, aux.detach(), {
                "dropped_frac": (dropped / routes.clamp_min(1.0)).detach()}
        return f

    def grads(self, params, ids, labels):
        """One forward and backward: ``(loss, aux, metrics, grads)``, the
        gradients by name."""
        loss, aux, metrics = self.loss_fn()(params, ids, labels)
        names = list(params)
        g = torch.autograd.grad(loss, [params[k] for k in names])
        return loss.detach(), aux, metrics, dict(zip(names, g))

    def make_train_step(self, optimizer):
        """``step(params, opt_state, ids, labels) -> (params, opt_state,
        metrics)``: one step of ``optimizer`` (the port's functional
        optimizers, updating this rank's shards in place)."""
        def step(params, opt_state, ids, labels):
            loss, aux, metrics, grads = self.grads(params, ids, labels)
            params, opt_state = optimizer.update(grads, opt_state, params)
            return params, opt_state, {"loss": loss, "aux_loss": aux,
                                       **metrics}
        return step
