"""Multi-chip / multi-host distribution over a jax.sharding.Mesh.

The reference is single-process single-device (SURVEY.md section 2.3); its
one parallel axis — one OpenCL work-item per pixel (ocltracer.go:197-210) —
generalizes here to a 2D device mesh:

    axis 'pixels'  : image tiles, data-parallel, no communication until
                     final assembly (the XLA output sharding gathers)
    axis 'spp'     : sample-partial images, reduced with psum (NCCL
                     all-reduce over NVLink)

Scene/BVH/material arrays are replicated on every device (they are < a few
MB). Host transfer happens once, for the final PNG.
"""
from .mesh import make_mesh, mesh_shape_for
from .multihost import global_render_mesh, initialize_multihost
from .render_dist import render_sharded

__all__ = ["make_mesh", "mesh_shape_for", "render_sharded",
           "initialize_multihost", "global_render_mesh"]
