from .model import SAM2  # noqa: F401
