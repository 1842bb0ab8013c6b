"""Model-side modules of the port: quantization helpers, the
transformer's layers, prefill, and the continuous-batching engine."""

from tpu_dra_driver_torch.workloads.models.quantize import (  # noqa: F401
    QTensor,
    quantize_params,
)
from tpu_dra_driver_torch.workloads.models.serving import (  # noqa: F401
    ServingEngine,
    paged_decode_step,
    paged_decode_steps,
)
from tpu_dra_driver_torch.workloads.models.transformer import (  # noqa: F401
    ModelConfig,
    init_params,
    stack_layer_params,
    unstack_layer_params,
)
from tpu_dra_driver_torch.workloads.models.generate import (  # noqa: F401
    block_prefill,
    init_kv_cache,
)
