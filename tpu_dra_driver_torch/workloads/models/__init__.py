"""Model-side modules of the port: quantization helpers, the
transformer (layers, training forward, loss, optimizer, train step),
KV-cache generation, and the continuous-batching engine, with their
throughput benchmarks."""

from tpu_dra_driver_torch.workloads.models.quantize import (  # noqa: F401
    QTensor,
    is_quantized,
    param_bytes,
    quantize_params,
)
from tpu_dra_driver_torch.workloads.models.serving import (  # noqa: F401
    ServingEngine,
    paged_decode_step,
    paged_decode_steps,
    serving_throughput,
)
from tpu_dra_driver_torch.workloads.models.transformer import (  # noqa: F401
    AdamW,
    ModelConfig,
    default_optimizer,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    param_count,
    stack_layer_params,
    train_tokens_per_sec,
    unstack_layer_params,
)
from tpu_dra_driver_torch.workloads.models.generate import (  # noqa: F401
    block_prefill,
    chunked_prefill,
    decode_step,
    decode_tokens_per_sec,
    evaluate_nll,
    generate,
    init_kv_cache,
    truncate_top_k,
    wide_step,
)
