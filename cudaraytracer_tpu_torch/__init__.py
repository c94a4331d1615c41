"""cudaraytracer_tpu_torch - the PyTorch and CUDA port of cudaraytracer_tpu.

The JAX package beside it is the reference.  This package keeps its layout
(core/ models/ ops/ utils/ apps/) and its public names, in PyTorch idiom:
plain functions on tensors, NamedTuples of tensors for the SoA tables, an
explicit device and an explicit ``torch.Generator`` for every draw.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.

This slice ports the fused forward render (``engine='mega'``): scene
building, the thin-lens camera, the three integrators in one hand-written
CUDA kernel (``csrc/megakernel.cu``) with its plain PyTorch version, the
chunked render loop and the PNG writer.
"""

from .config import Quirks, RenderConfig
from .core.camera import Camera, make_camera
from .core.rays import Rays, make_rays
from .models.materials import MaterialBuilder
from .models.scene import Scene, SceneBuilder
from .models.textures import TextureBuilder
from .ops.render import render_image, render_pixels

__version__ = "0.1.0"

__all__ = [
    "Quirks", "RenderConfig", "Camera", "make_camera", "Rays", "make_rays",
    "MaterialBuilder", "Scene", "SceneBuilder", "TextureBuilder",
    "render_image", "render_pixels",
]
