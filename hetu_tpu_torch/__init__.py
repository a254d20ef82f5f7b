"""hetu_tpu_torch: the PyTorch / CUDA port of hetu_tpu, for NVIDIA Hopper.

A second package beside ``hetu_tpu`` (the JAX reference, unchanged).  Module
paths and names mirror the reference so each counterpart is found at once:

    import hetu_tpu_torch as htt
    htt.ops.*         # functional ops on torch tensors
    htt.ops.cuda_kernels.flash_attention   # hand-written sm_90a kernels,
                                           # forward and backward
    htt.init.*        # initializers on an explicit torch.Generator
    htt.rng           # global (seed, seqnum) -> torch.Generators
    htt.layers.*      # nn.Modules: Linear, LayerNorm, MultiHeadAttention,
                      # TransformerBlock
    htt.models.*      # GPT, MoE transformer, Llama (lm_loss_fn for
                      # training), BERT (pretrain_loss_fn), the CTR models
    htt.optim.*       # SGD ... AdamW, Lamb (dense and sparse paths)
    htt.lr.*          # step -> lr schedulers
    htt.train.*       # Executor, TrainState, checkpoint
    htt.interop       # hetu_tpu parameter / optimizer trees <-> state_dicts
    htt.serve.*       # ServeEngine, ContinuousBatchingScheduler, metrics,
                      # migrate (live KV-slot migration)
    htt.quantwire     # int8 block codec of migration payloads
    htt.telemetry.*   # span tracer + typed metrics registry
    htt.data.*        # bucketed padding of CTR batches
    htt.utils.metrics # AUC, accuracy, F1 on host arrays
    htt.ps.*          # the parameter server's in-process tier (C++, built
                      # with g++ on first use) and PSEmbedding

The package never imports ``jax`` or ``hetu_tpu``.  Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU, where every
kernel wrapper computes its plain PyTorch version instead.  Subpackages
import lazily, so ``import hetu_tpu_torch`` stays cheap.
"""

from hetu_tpu_torch.version import __version__

_LAZY = {"ops", "init", "rng", "layers", "models", "optim", "lr", "train",
         "interop", "serve", "telemetry", "data", "utils", "ps",
         "quantwire"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"hetu_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'hetu_tpu_torch' has no attribute {name!r}")


__all__ = ["__version__", *sorted(_LAZY)]
