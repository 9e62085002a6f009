"""Device-side render pipelines: the jitted-JAX wavefront integrator and
the Pallas megakernel (pallas_kernel.py).

Replaces the reference's OpenCL megakernel (internal/ocl/tracer.cl:831-1188)
with staged, batched, statically-shaped compute:

    ray-gen -> intersect (primitives + skip-link BVH) -> shade -> accumulate
"""
from .camera import Camera, CameraArrays
from .integrator import render, render_rays

__all__ = ["Camera", "CameraArrays", "render", "render_rays"]
