"""SpMV kinds. Importing this package registers all built-in kinds.

Every device kind runs one of three implementations, and
`spmv_tpu.ops.registry.implementation` says which one a call gets:

| implementation | kinds                                  | module        |
|----------------|----------------------------------------|---------------|
| ``hopper``     | merge*, csr_*, light_*, stream         | ``merge.py``  |
| ``plain``      | ``xla`` (alias ``cusparse``); any kind | ``baseline``  |
|                | for dtypes and semirings the merge-    |               |
|                | path kernel does not serve             |               |
| ``dia``        | ``dia`` on diagonal-sparse matrices    | ``dia.py``    |

``cpu_naive`` runs the host oracle and ``dense`` a dense matvec.
"""

from spmv_tpu.kernels import baseline  # noqa: F401  (registers cpu_naive, xla, dense)
from spmv_tpu.kernels import dia  # noqa: F401
from spmv_tpu.kernels import merge  # noqa: F401
