"""LLaMA serving slice of the port: packed linears, model blocks, INT8 KV
cache, prefill/decode and the fixed-slot DecodeEngine."""
