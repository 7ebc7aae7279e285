# Data-plane distribution: the scrub farm (one equal shard of a batch per
# device) and elastic pool resizing driven by the autoscaler. The training
# plane's gradient compression (int8/top-k with error feedback) comes with
# the port of the LM stack and is not here yet.
from repro_torch.distributed.scrub_farm import ScrubFarm, bucket_by_resolution
from repro_torch.distributed.elastic import ElasticFarmController

__all__ = [
    "ScrubFarm",
    "bucket_by_resolution",
    "ElasticFarmController",
]
