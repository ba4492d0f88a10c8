"""Multi-device execution on `torch.distributed` (port of
`hitadv_tpu/parallel`): one process per device, NCCL between CUDA
devices, gloo on the CPU.

  * `mesh`: the process group (`make_mesh`), the launch of its ranks on
    one host or several (`spawn`, `hosts`), the placement of a batch
    (`put_batch`) and batch sharding (`shard_attack`);
  * `population`: R independent restarts of one batch, the first success
    kept per example (`population_attack`);
  * `ring`: the Chamfer and Hausdorff distances with the points sharded
    over the ranks, the other cloud's blocks passed round a ring
    (`ring_chamfer`, `ring_hausdorff`).
"""

from hitadv_torch.parallel.mesh import (  # noqa: F401
    hosts,
    make_mesh,
    put_batch,
    shard_attack,
    spawn,
)
from hitadv_torch.parallel.population import population_attack, restart_generators  # noqa: F401
from hitadv_torch.parallel.ring import ring_chamfer, ring_hausdorff  # noqa: F401
