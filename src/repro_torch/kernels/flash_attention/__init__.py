"""GQA flash-attention forward, causal or not: CUDA kernel (``kernel``), plain
version (``ref``) and the model-layout wrapper (``ops``)."""
