"""Image, mesh and file utilities (numpy only), copied from
``glimslib_tpu/utils/``; ``data_io``'s mesh and function store is the
port's own (``.npz``)."""
