"""Kernels of the port and their plain PyTorch versions.

K1 ``quant_matmul.quant_matmul_s4``, K2 ``attention.decode_attention_update``,
K3 ``ffn_fused.ffn_block_fused``, K4 ``layer_fused.fused_decoder_layers``,
K5 ``attention.decode_attention``, K6/K7/K8 ``quant_matmul.quant_matmul_w_a8``
/ ``quant_matmul_3bit`` / ``quant_matmul_w``, K9 ``matvec.bf16_matvec`` and
K10 ``flash_attention.flash_attention``; each counts its kernel launches in a
``launches`` attribute.
"""
