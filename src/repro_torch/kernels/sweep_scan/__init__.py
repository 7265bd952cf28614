"""The scheduler's sweep engine: CUDA kernel (``kernel``), plain version
(``ref``) and the dispatching wrapper (``ops``)."""
