"""Flash-attention forward: `ref.py` (plain) and `ops.py` (wrapper of
`csrc/flash_attention.cu`)."""
