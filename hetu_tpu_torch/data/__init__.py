"""Data utilities (counterpart of ``hetu_tpu/data``): bucketed padding."""

from hetu_tpu_torch.data.bucketing import (
    BucketedLoader, pad_batch, pow2_bucket,
)

__all__ = ["BucketedLoader", "pad_batch", "pow2_bucket"]
