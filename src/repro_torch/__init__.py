"""PyTorch + CUDA port of the RgCSR sparse-matrix system (``repro``).

``repro_torch`` mirrors the JAX package file for file: ``core`` holds the
paper's formats, the SpMV/SpMM oracles and dispatch, ``kernels`` the plan
layer and the hand-written Hopper kernels that replace the Pallas ones.  It
imports torch, numpy and scipy only — never jax, never ``repro``.
"""
