"""Utilities of the port: benchmark timing on the card, train-state
checkpoints and profiler traces."""

from tpu_dra_driver_torch.workloads.utils.timing import (  # noqa: F401
    Timed,
    chain_seconds_per_step,
    device_seconds_per_step,
    marginal_chain_rate,
    time_fn,
)
from tpu_dra_driver_torch.workloads.utils.checkpoint import (  # noqa: F401
    abstract_like,
    latest_step,
    list_steps,
    restore_train_state,
    save_train_state,
)
from tpu_dra_driver_torch.workloads.utils.profiling import (  # noqa: F401
    annotate,
    latest_trace,
    trace_to,
)
