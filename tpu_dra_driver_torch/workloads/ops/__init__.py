"""Attention ops of the port: the oracle attention, flash attention for
training, the paged decode read and the flash-decode read over a
contiguous cache, with their hand-written CUDA kernels; the attention
and matrix-product benchmarks."""

from tpu_dra_driver_torch.workloads.ops.collectives import (  # noqa: F401
    matmul_tflops,
    matmul_tflops_steady,
)
from tpu_dra_driver_torch.workloads.ops.attention import (  # noqa: F401
    attention_reference,
    flash_attention,
    flash_attention_long_context_tflops,
    flash_attention_tflops,
    flash_attention_train_tflops,
    flash_attention_with_lse,
    merge_partials,
)
from tpu_dra_driver_torch.workloads.ops.decode_attention import (  # noqa: F401
    decode_block_t,
    flash_decode_attention,
    flash_decode_attention_plain,
    round_up_kv,
)
from tpu_dra_driver_torch.workloads.ops.paged_attention import (  # noqa: F401
    init_pool,
    paged_attention_reference,
    paged_decode_attention,
    paged_decode_attention_plain,
    pool_append,
)
