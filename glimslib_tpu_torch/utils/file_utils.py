# Copy of glimslib_tpu/utils/file_utils.py (numpy only). The code is kept
# byte for byte apart from imports, which point into glimslib_tpu_torch so
# that the port never imports the JAX package.
"""File utilities (rebuild of reference ``glimslib/utils/file_utils.py``)."""

import os
import shutil


def get_file_extension(path):
    """Extension without leading dot (reference file_utils.py:6-12)."""
    ext = os.path.splitext(path)[1]
    return ext[1:] if ext.startswith(".") else ext


def ensure_dir_exists(path):
    """Create directory (of a file path or dir path) if needed
    (reference file_utils.py:22-37)."""
    if os.path.splitext(path)[1]:
        directory = os.path.dirname(path)
    else:
        directory = path
    if directory:
        os.makedirs(directory, exist_ok=True)
    return directory


def remove_dir(path):
    shutil.rmtree(path, ignore_errors=True)
