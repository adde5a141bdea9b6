"""Solvers of the port: PCG and the coupled implicit-Euler step."""
