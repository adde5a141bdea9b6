"""Operators of the port: forms, P1 assembly, offset-stencil planes and the
CUDA kernels that apply and solve them."""
