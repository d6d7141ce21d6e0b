"""fidget_tpu_torch — the PyTorch and CUDA port of fidget_tpu.

Expression graphs are deduplicated and lowered to fidget's register
tapes (host-side numpy, bit-identical to `fidget_tpu`), then evaluated
in point, interval and dual-number modes across pixel and voxel lanes
by hand-written CUDA kernels for Hopper (csrc/), with a plain PyTorch
version of each kernel for the CPU. The 2D renderer (`PixelRenderer`)
and the 3D heightmap + normals renderer (`VoxelRenderer`) are built on
them, and so are bulk evaluation (`BulkEvaluator`), Manifold Dual
Contouring meshing (`build_mesh`) and shape-parameter gradients of the
2D frame (`interp_float` is a `torch.autograd.Function`). Entry points
run on the card unless the caller passes `device="cpu"`.

This package imports neither JAX nor `fidget_tpu`.
"""

from .compiler.lower import lower
from .compiler.simplify import simplify
from .compiler.tape import Tape, TapeOp
from .core.context import Context
from .core.ops import BinaryOp, UnaryOp
from .core.tree import Tree, tree_max, tree_min
from .core.var import Var, VarMap
from .eval.bulk import BulkEvaluator
from .mesh import Mesh, build_mesh
from .mesh import Settings as MeshSettings
from .render.region import ImageSize, VoxelSize
from .render.render2d import Image2D, PixelRenderer
from .render.render2d import render as render2d
from .render.render3d import Image3D, VoxelRenderer
from .render.render3d import render as render3d
from .shape import Shape, ShapeVars

__version__ = "0.1.0"

__all__ = [
    "BinaryOp",
    "BulkEvaluator",
    "Context",
    "Image2D",
    "Image3D",
    "ImageSize",
    "Mesh",
    "MeshSettings",
    "PixelRenderer",
    "Shape",
    "ShapeVars",
    "Tape",
    "TapeOp",
    "Tree",
    "UnaryOp",
    "Var",
    "VarMap",
    "VoxelRenderer",
    "VoxelSize",
    "build_mesh",
    "lower",
    "render2d",
    "render3d",
    "simplify",
    "tree_max",
    "tree_min",
    "__version__",
]
