# Data-plane distribution: the scrub farm (one equal shard of a batch per
# device), elastic pool resizing driven by the autoscaler, and gradient
# compression (int8/top-k with error feedback) for the training plane.
from repro_torch.distributed.scrub_farm import ScrubFarm, bucket_by_resolution
from repro_torch.distributed.elastic import ElasticFarmController
from repro_torch.distributed.compression import (
    int8_compress,
    int8_decompress,
    topk_compress,
    topk_decompress,
    CompressionState,
    compressed_psum_int8,
)

__all__ = [
    "ScrubFarm",
    "bucket_by_resolution",
    "ElasticFarmController",
    "int8_compress",
    "int8_decompress",
    "topk_compress",
    "topk_decompress",
    "CompressionState",
    "compressed_psum_int8",
]
