"""The port's native host helpers (g++ library, ctypes, scipy fallback)."""

from glimslib_tpu_torch.native.meshops import rcm_permutation

__all__ = ["rcm_permutation"]
