"""Attention ops of the port: the oracle attention, flash attention for
training and the paged decode read, with their hand-written CUDA
kernels."""

from tpu_dra_driver_torch.workloads.ops.attention import (  # noqa: F401
    attention_reference,
    flash_attention,
    flash_attention_with_lse,
    merge_partials,
)
from tpu_dra_driver_torch.workloads.ops.paged_attention import (  # noqa: F401
    init_pool,
    paged_attention_reference,
    paged_decode_attention,
    paged_decode_attention_plain,
    pool_append,
)
