"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

The JAX package (``src/repro``) is the reference; this package mirrors its
subpackage layout and public signatures.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU, where every kernel
wrapper takes its plain PyTorch version.  Nothing here imports JAX.
"""
