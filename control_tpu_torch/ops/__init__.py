from .local_op import LocalOp, MaskedOp

__all__ = ["LocalOp", "MaskedOp"]
