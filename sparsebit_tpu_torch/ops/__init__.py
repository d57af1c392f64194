"""Kernels of the port and their plain PyTorch versions.

K1 ``quant_matmul.quant_matmul_s4``, K2 ``attention.decode_attention_update``,
K3 ``ffn_fused.ffn_block_fused`` and K9 ``matvec.bf16_matvec``; each
counts its kernel launches in a ``launches`` attribute.
"""
