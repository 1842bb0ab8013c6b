"""Model-side modules of the port: quantization helpers, the
transformer (layers, training forward, loss, optimizers, train step),
LoRA adapters, the masked-LM encoder, the encoder-decoder family,
KV-cache generation, beam search, speculative decoding and the
continuous-batching engine, with their throughput benchmarks.

The names are those the reference's ``models`` exports, less
``seq2seq_param_shardings``, which waits for the port's multi-GPU tier
(and ``quantize``, a module name here)."""

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
    Adafactor,
    AdamW,
    ModelConfig,
    default_optimizer,
    forward,
    init_params,
    loss_fn,
    loss_positions,
    make_train_step,
    nll_from_logits,
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
from tpu_dra_driver_torch.workloads.models.lora import (  # noqa: F401
    init_lora,
    lora_param_counts,
    make_lora_train_step,
    merge_lora,
)
from tpu_dra_driver_torch.workloads.models.encoder import (  # noqa: F401
    encoder_config,
    make_mlm_train_step,
    mlm_accuracy,
    mlm_corrupt,
    mlm_loss_fn,
)
from tpu_dra_driver_torch.workloads.models.beam import (  # noqa: F401
    beam_search,
    sequence_logprob,
)
from tpu_dra_driver_torch.workloads.models.speculative import (  # noqa: F401
    self_speculative_generate,
    speculative_decode_tokens_per_sec,
    speculative_generate,
    speculative_sample,
)
from tpu_dra_driver_torch.workloads.models.seq2seq import (  # noqa: F401
    Seq2SeqConfig,
    greedy_decode,
    init_seq2seq_params,
    make_seq2seq_train_step,
    seq2seq_loss_fn,
)
