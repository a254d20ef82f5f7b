"""Data utilities (counterpart of ``hetu_tpu/data``): the CIFAR-10 and MNIST
loaders, the batching Dataloader, the elastic batch schedule and bucketed
padding."""

from hetu_tpu_torch.data import datasets
from hetu_tpu_torch.data.bucketing import (
    BucketedLoader, pad_batch, pow2_bucket,
)
from hetu_tpu_torch.data.dataloader import Dataloader, ElasticBatchSchedule

__all__ = ["BucketedLoader", "pad_batch", "pow2_bucket", "datasets",
           "Dataloader", "ElasticBatchSchedule"]
