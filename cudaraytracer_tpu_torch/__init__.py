"""cudaraytracer_tpu_torch - the PyTorch and CUDA port of cudaraytracer_tpu.

The JAX package beside it is the reference.  This package keeps its layout
(core/ models/ ops/ utils/ apps/) and its public names, in PyTorch idiom:
plain functions on tensors, NamedTuples of tensors for the SoA tables, an
explicit device and an explicit ``torch.Generator`` for every draw.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.

Ported so far:
  * the fused forward render (``engine='mega'``): scene building, the
    thin-lens camera, the three integrators in one hand-written CUDA kernel
    (``csrc/megakernel.cu``) with its plain PyTorch version, the chunked
    render loop and the PNG writer;
  * the differentiable wavefront (``engine='wavefront'``, the default) and
    the single-device fit: the closest-hit sweep kernels
    (``csrc/sweeps.cu``, ``ops/sweeps.py``) inside autograd Functions, the
    per-bounce draws kernel, hit records, materials and integrators as
    tensor ops (``ops/intersect.py``, ``ops/integrators.py``),
    ``parallel/train.py`` and ``apps/fit.py``;
  * the differentiable fused engine (``engine='mega_diff'``), rects and
    runtime-TRS prims, image textures;
  * scenes above 8,192 prims of a type (the segment level), the
    compaction drivers and their routing (``ops.megakernel.select_mega``)
    and front-to-back shells;
  * the BVH, skinned animation and the reference's active pipeline;
  * the wavefront's alive-first compaction (``wavefront_compact``), and
    rendering and training over a ('dp', 'tp') mesh of ranks on
    ``torch.distributed`` (``parallel/``), with the multi-rank dry run and
    ``apps/scaling.py``;
  * tracing: ``utils/profiling.py``'s spans inside the render, the fused
    engine's table build and replay, the wavefront's bounces and the fit
    step, recorded while a ``torch.profiler`` session runs (or after
    ``profiling.enable()``) on the trace's own clock, read by the profile
    apps and the benchmark.
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
