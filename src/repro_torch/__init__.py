"""PyTorch/CUDA port of the reproduction, beside the JAX package ``repro``.

It imports ``torch`` and ``numpy`` and nothing of JAX or ``repro``; what it
needs of the planner core it carries as its own copy.  Entry points run on
CUDA unless the caller passes ``device="cpu"``.
"""
