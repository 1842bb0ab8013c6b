"""Multi-device workloads of the port: the mesh and its sharding rules,
ring and Ulysses sequence-parallel attention, and the GPipe pipeline;
the explicit collectives of the sharded steps are in :mod:`.spmd`.

The names are those the reference's ``parallel`` exports, and the
public functions of its ``pipeline`` module."""

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
from tpu_dra_driver_torch.workloads.parallel.pipeline import (  # noqa: F401
    make_pp_forward,
    make_pp_train_step,
    params_to_pp,
    pipeline_apply,
    pp_param_shardings,
    stack_layers,
    stage_shardings,
)
