"""Mamba2 chunked SSD scan forward: CUDA kernel (``kernel``), plain version
(``ref``) and the model-layout wrapper (``ops``)."""
