"""Reference-compatible sub-config (reference ``glimslib/visualisation/config.py``:
interactive-backend detection + temp figure dir).

Counterpart of ``glimslib_tpu/visualisation/config.py``, which imports
matplotlib and selects its backend at import.  The port does both in
:func:`require_matplotlib`, called where a plot is about to be drawn: the
card's host has no matplotlib, and every module of the port imports
there."""

import os

from glimslib_tpu_torch.config import output_dir

# backend detection: non-interactive when no display (reference behavior)
interactive = bool(os.environ.get("DISPLAY"))

output_dir_tmp_figures = os.path.join(output_dir, "tmp_figures")


def require_matplotlib():
    """matplotlib, with the Agg backend where there is no display (the
    reference's choice at import); ``ImportError`` naming matplotlib where
    it does not import."""
    try:
        import matplotlib
    except ImportError as err:
        raise ImportError(
            "plotting needs matplotlib, which does not import here") from err
    if not interactive:
        matplotlib.use("Agg")
    return matplotlib
