"""hetu_tpu_torch: the PyTorch / CUDA port of hetu_tpu, for NVIDIA Hopper.

A second package beside ``hetu_tpu`` (the JAX reference, unchanged).  Module
paths and names mirror the reference so each counterpart is found at once:

    import hetu_tpu_torch as htt
    htt.ops.*         # functional ops on torch tensors
    htt.ops.cuda_kernels.flash_attention   # hand-written sm_90a kernels,
                                           # forward and backward
    htt.init.*        # initializers on an explicit torch.Generator
    htt.rng           # global (seed, seqnum) -> torch.Generators
    htt.layers.*      # nn.Modules: Linear, Conv2d, LayerNorm, BatchNorm
                      # (running statistics as buffers), pools, DropOut,
                      # Sequential, MultiHeadAttention, TransformerBlock,
                      # MoELayer and its five gates, the RNN cells and RNN
    htt.models.*      # GPT, MoE transformer, Llama (lm_loss_fn for
                      # training), BERT (pretrain_loss_fn), the CTR models,
                      # ResNet, VGG, LeNet, MLP (classifier_loss_fn), GCN,
                      # RNNClassifier
    htt.optim.*       # SGD ... AdamW, Lamb (dense and sparse paths)
    htt.lr.*          # step -> lr schedulers
    htt.train.*       # Executor (mesh=, dist_strategy=, grad_sync=),
                      # TrainState, checkpoint, gradients
    htt.parallel.*    # make_mesh (also htt.make_mesh), the rank processes,
                      # collectives, ShardSpec, the strategies
    htt.interop       # hetu_tpu parameter / optimizer trees <-> state_dicts
    htt.serve.*       # ServeEngine, ContinuousBatchingScheduler, metrics,
                      # migrate (live KV-slot migration, its van wire),
                      # InferenceServer / InferenceClient over the van
    htt.quantwire     # int8 block codec of migration payloads, the PS
                      # gradient wire's dtypes
    htt.embedding_compress  # the 19 compression methods, the stage
                      # scheduler, the AutoDim and OptEmbed flows, the
                      # serving cache's row codec
    htt.serve.ServingPool  # routing, planned drain with live KV
                      # migration, engine-death failover over N engines
    htt.telemetry.*   # span tracer, typed metrics registry, chaos
                      # timeline, fleet stream merge, costs, live health
    htt.resilience.*  # seeded fault schedules and their injector
    htt.traffic.*     # seeded open-loop traces and their replay, the
                      # measured-load autoscaler over the process pool
    htt.data.*        # CIFAR-10 and MNIST, the Dataloader, bucketed
                      # padding of CTR batches, the graph sampler over PS
                      # tables
    htt.utils.metrics # AUC, accuracy, F1 on host arrays
    htt.ps.*          # the parameter server (C++, built with g++ on
                      # first use): the in-process tier, SSP, PReduce;
                      # van: remote and partitioned tables, the remote
                      # HET cache, the scheduler role, the blob channel;
                      # PSEmbedding over any tier

The package never imports ``jax`` or ``hetu_tpu``.  Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU, where every
kernel wrapper computes its plain PyTorch version instead.  Subpackages
import lazily, so ``import hetu_tpu_torch`` stays cheap.
"""

from hetu_tpu_torch.version import __version__

_LAZY = {"ops", "init", "rng", "layers", "models", "optim", "lr", "train",
         "interop", "serve", "telemetry", "data", "utils", "ps",
         "quantwire", "embedding_compress", "resilience",
         "traffic", "parallel"}


def __getattr__(name):
    if name == "make_mesh":
        from hetu_tpu_torch.parallel.mesh import make_mesh
        return make_mesh
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"hetu_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'hetu_tpu_torch' has no attribute {name!r}")


__all__ = ["__version__", "make_mesh", *sorted(_LAZY)]
