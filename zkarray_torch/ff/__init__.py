"""Prime-field arithmetic."""

from zkarray_torch.ff import fp

__all__ = ["fp"]
