"""Decode attention over a KV cache, one query a sequence, up to each
sequence's length: split-KV CUDA kernels (``kernel``), plain version
(``ref``) and the dispatching op (``ops``)."""
