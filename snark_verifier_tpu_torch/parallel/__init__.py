from .batch_verify import batch_verify

__all__ = ["batch_verify"]
