"""fidget_tpu_torch — the PyTorch and CUDA port of fidget_tpu.

Expression graphs are deduplicated and lowered to fidget's register
tapes (host-side numpy, bit-identical to `fidget_tpu`), then evaluated
in point and interval modes across pixel lanes by hand-written CUDA
kernels for Hopper (csrc/), with a plain PyTorch version of each kernel
for the CPU. Entry points run on the card unless the caller passes
`device="cpu"`.

This package imports neither JAX nor `fidget_tpu`.
"""

from .compiler.lower import lower
from .compiler.tape import Tape, TapeOp
from .core.context import Context
from .core.ops import BinaryOp, UnaryOp
from .core.tree import Tree, tree_max, tree_min
from .core.var import Var, VarMap
from .render.region import ImageSize
from .render.render2d import Image2D, PixelRenderer
from .render.render2d import render as render2d

__version__ = "0.1.0"

__all__ = [
    "BinaryOp",
    "Context",
    "Image2D",
    "ImageSize",
    "PixelRenderer",
    "Tape",
    "TapeOp",
    "Tree",
    "UnaryOp",
    "Var",
    "VarMap",
    "lower",
    "render2d",
    "tree_max",
    "tree_min",
    "__version__",
]
