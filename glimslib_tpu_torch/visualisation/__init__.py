"""Plotting of fields, images and segmentations (counterpart of
``glimslib_tpu/visualisation/``).  numpy and matplotlib code; matplotlib
is imported only when a plot is drawn, so every module here imports on a
host without it, and a call that draws there raises ``ImportError``
naming it."""
