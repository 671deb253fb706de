"""LCI-X on PyTorch and CUDA — the port of the JAX package ``repro``.

``repro_torch/x/y.py`` mirrors ``repro/x/y.py``; the JAX package is the
reference every ported part is held against.  This package imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``); with no GPU present and no explicit CPU
request, construction raises.
"""
