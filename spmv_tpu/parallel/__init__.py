from spmv_tpu.parallel.partition import RowPartition, partition_rows
from spmv_tpu.parallel.dist_spmv import DistributedSpMV, distribute_csr
from spmv_tpu.parallel.bootstrap import (
    init_distributed,
    make_mesh,
    put_global,
)

__all__ = [
    "RowPartition",
    "partition_rows",
    "DistributedSpMV",
    "distribute_csr",
    "init_distributed",
    "make_mesh",
    "put_global",
]
