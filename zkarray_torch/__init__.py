"""zkarray_torch — the PyTorch/CUDA port of zkarray for NVIDIA Hopper.

Same data model as the JAX package beside it: a field array is a planar,
limb-major tensor ``int32[L, *batch]`` of base-2^16 limbs (values < 2^16),
with Montgomery radix R = 2^(16 L); a small-field array (ff/smallfp.py,
fp64.py, smallfp64.py) is ``torch.uint32[*batch]`` or, for 64-bit fields,
``torch.uint32[2, *batch]``, the JAX package's words. Every public function runs on the device
of its input tensors; constructors take ``device=`` and default to
``DEFAULT_DEVICE``. Hot loops run in hand-written CUDA kernels
(``zkarray_torch/kernels/csrc``); a tensor on the CPU takes each kernel's
plain PyTorch version instead.

This package imports torch and numpy only: no JAX, and nothing of ``zkarray``.
"""

DEFAULT_DEVICE = "cuda"

# after DEFAULT_DEVICE, which ff/fp.py imports from here
from zkarray_torch.core.fieldspec import FieldSpec  # noqa: E402
from zkarray_torch.ff import fp  # noqa: E402

__version__ = "0.1.0"

__all__ = ["FieldSpec", "fp", "__version__"]
