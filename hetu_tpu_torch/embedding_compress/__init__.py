"""The embedding memory-compression zoo (counterpart of
``hetu_tpu/embedding_compress``): 19 methods, the stage scheduler, the
AutoDim and OptEmbed training flows and the serving cache's row codec."""

from hetu_tpu_torch.embedding_compress.layers import (
    HashEmbedding, CompositionalEmbedding, DPQEmbedding, MGQEEmbedding,
    TensorTrainEmbedding, DHEEmbedding, ROBEEmbedding, QuantizedEmbedding,
    ALPTEmbedding, PrunedEmbedding, PEPEmbedding, OptEmbedEmbedding,
    AutoSRHEmbedding, MixedDimEmbedding, AutoDimEmbedding, DedupEmbedding,
    AdaptiveEmbedding, SparseEmbedding, MaskedEmbedding,
    pep_to_retrain, autosrh_to_retrain, autodim_to_retrain,
    optembed_row_pruned,
)
from hetu_tpu_torch.embedding_compress.scheduler import CompressionScheduler
from hetu_tpu_torch.embedding_compress.recipes import (
    AutoDimBiLevelTrainer, MultiStageFlow, OptEmbedFlow, ServingRowCodec,
)
