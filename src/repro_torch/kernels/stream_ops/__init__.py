"""The streaming runtime's operator bodies: CUDA kernels (``kernel``), plain
versions (``ref``) and the dispatching wrappers (``ops``)."""
