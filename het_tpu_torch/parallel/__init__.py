"""Data parallelism over destination-partitioned shards: the partitioner,
the halo exchanges, ``DPGNN`` and its training step."""

from .dp import (DPGNN, halo_bytes, halo_exchange,  # noqa: F401
                 halo_gather, masked_nll, setup_rank, sum_grads, train_dp,
                 train_full)
from .partition import (PartitionInfo, halo_back_index,  # noqa: F401
                        partition_by_dst)
