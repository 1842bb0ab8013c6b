"""Attention ops of the port: the oracle attention, and the paged decode
read with its hand-written CUDA kernel."""

from tpu_dra_driver_torch.workloads.ops.attention import (  # noqa: F401
    attention_reference,
)
from tpu_dra_driver_torch.workloads.ops.paged_attention import (  # noqa: F401
    init_pool,
    paged_attention_reference,
    paged_decode_attention,
    paged_decode_attention_plain,
    pool_append,
)
