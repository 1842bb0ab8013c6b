"""Multi-device workloads of the port: the mesh and its sharding rules,
and ring and Ulysses sequence-parallel attention; the explicit
collectives of the sharded step are in :mod:`.spmd`.

The names are those the reference's ``parallel`` exports; its
``pipeline`` module is not ported yet."""

from tpu_dra_driver_torch.workloads.parallel.mesh import (  # noqa: F401
    build_mesh,
    build_mesh_spmd,
    batch_sharding,
    replicated,
    param_shardings,
    zero1_opt_shardings,
)
from tpu_dra_driver_torch.workloads.parallel.ringattention import (  # noqa: F401
    make_ring_attention,
    make_ulysses_attention,
    ring_attention,
    ulysses_attention,
)
