"""LLaMA slice of the port: packed linears, the model and its full-sequence
forward, INT8 KV cache, prefill/decode, the engines and perplexity."""

from sparsebit_tpu_torch.llm.llama import (  # noqa: F401
    LlamaConfig,
    init_llama_params,
    llama_forward,
)
