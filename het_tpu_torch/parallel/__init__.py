"""Data parallelism over destination-partitioned shards: the partitioner,
the halo exchanges, ``DPGNN`` and its training step."""

from .dp import (DPGNN, Mesh2, halo_bytes,  # noqa: F401
                 halo_exchange, halo_gather, make_mesh2, masked_nll,
                 setup_rank, sum_grads, timed_collectives, train_dp,
                 train_full)
from .partition import (PartitionInfo, halo_back_index,  # noqa: F401
                        partition_by_dst)
