"""UFVideo in PyTorch and CUDA: the port of ``ufvideo_tpu`` to an NVIDIA
H100. Imports torch and numpy only (never JAX or ``ufvideo_tpu``).

``model_init`` and the entry points ``mm_infer`` / ``mm_infer_stream`` /
``mm_infer_batch`` are loaded lazily, so importing the package builds and
loads nothing.
"""

__all__ = ["model_init", "mm_infer", "mm_infer_stream", "mm_infer_batch"]


def __getattr__(name):
    if name in __all__:
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module 'ufvideo_tpu_torch' has no attribute {name!r}")
