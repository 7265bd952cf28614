"""Dropless grouped expert FFN (relu^2): CUDA kernels (``csrc/moe_grouped.cu``,
bound by ``kernel``), plain version (``ref``) and the wrapper that
dispatches on the device (``ops``)."""
