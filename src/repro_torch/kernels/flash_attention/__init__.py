"""Causal GQA flash-attention forward: CUDA kernel (``kernel``), plain
version (``ref``) and the model-layout wrapper (``ops``)."""
