"""Plain PyTorch reference of the coupled tumour-growth model.

A classic finite-element discretisation written apart from the port:
its own Kuhn mesh and dof numbering (``mesh.py``), Grundmann-Moeller
quadrature (``quadrature.py``), CSR matrices assembled element by element
and applied by ``torch.sparse`` (``fem.py``), Newton and Jacobi-CG in
float64 (``model.py``), and the inverse problem's objective with a
central-difference gradient (``inverse.py``).  It imports only ``torch``
and ``numpy``; nothing of ``glimslib_tpu_torch`` or ``glimslib_tpu``.
"""
