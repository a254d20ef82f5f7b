"""Data utilities (counterpart of ``hetu_tpu/data``): the CIFAR-10 and MNIST
loaders, the batching Dataloader, the elastic batch schedule, bucketed
padding and the graph sampler over PS tables."""

from hetu_tpu_torch.data import datasets, graph_sampler
from hetu_tpu_torch.data.bucketing import (
    BucketedLoader, pad_batch, pow2_bucket,
)
from hetu_tpu_torch.data.dataloader import Dataloader, ElasticBatchSchedule

__all__ = ["BucketedLoader", "pad_batch", "pow2_bucket", "datasets",
           "graph_sampler", "Dataloader", "ElasticBatchSchedule"]
