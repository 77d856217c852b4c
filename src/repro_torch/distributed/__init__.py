from repro_torch.distributed import sharding
from repro_torch.distributed.elastic import reshard_state

__all__ = ["sharding", "reshard_state"]
