"""pathtracer: a differentiable Monte-Carlo path tracer in JAX.

A from-scratch rebuild of the capability set of the Go+OpenCL reference renderer
``eriklupander/pathtracer-ocl`` (see SURVEY.md), running on GPUs:

- ``geometry``  pure-math core (tuples, 4x4 matrices, transforms, rays)
- ``scene``     host-side scene graph, materials, OBJ/MTL parsing, BVH build,
                and flattening to a static struct-of-arrays device layout
- ``render``    the wavefront render pipeline (ray-gen -> intersect/BVH ->
                shade/bounce -> accumulate) as jitted JAX, plus the Pallas
                megakernel (render/pallas_kernel.py)
- ``parallel``  shard_map distribution over a device mesh
- ``diff``      differentiable rendering: gradients of image loss w.r.t.
                material/emission parameters, psum-reduced training step
- ``io``        PNG and big-endian .raw image writers (format-compatible with
                the reference's internal/app/raw/writer.go)
- ``scenes``    the reference's 15 named scene configurations
"""

__version__ = "0.1.0"
