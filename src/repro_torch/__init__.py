"""PyTorch/CUDA port of the ternary LLM serving path (``repro``'s twin).

Mirrors ``src/repro``'s layout: ``configs``, ``core`` (packing, ternary
quantization, parameters, BitLinear), ``kernels`` (hand-written CUDA kernels
for the Hopper H100 beside their plain PyTorch versions), ``models`` and
``serving``. It imports ``torch`` only — never ``jax`` and nothing of
``repro`` — so it runs on a machine without JAX. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""
