"""Image and mesh utilities of the 2D atlas problems, copied from
``glimslib_tpu/utils/`` (numpy only)."""
