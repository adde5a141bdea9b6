"""Mesh, elements, subdomains, parameters, boundary conditions and function
spaces of the port (counterpart of ``glimslib_tpu/core``)."""
