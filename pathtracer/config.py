"""Render configuration.

Equivalent of the reference's pflag/viper config
(reference: cmd/configuration.go:5-32, cmd/pt/main.go:48-56).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration.

    Mirrors the reference CLI flags --width --height --samples --aperture
    --focal-length (cmd/pt/main.go:48-56) plus device-side knobs.
    """

    width: int = 640
    height: int = 480
    samples: int = 1
    aperture: float = 0.0
    focal_length: float = 0.0

    # -- device-side ---------------------------------------------------
    # f32 is the fast path (the reference computes in f64 end-to-end,
    # tracer.cl `double`; f32 parity is established in
    # tests/test_precision.py). f64 runs the wavefront path on any
    # backend (CPU golden tests, and the GPU's f64 units).
    dtype: str = "float32"
    # Reference uses EPSILON=1e-4 in float64 (tracer.cl:4). The same value
    # works in f32 at the reference's ~unit scene scale.
    epsilon: float = 1e-4
    # Bounce budget (tracer.cl:2-3).
    max_bounces: int = 10
    max_effective_bounces: int = 4
    # Intersections beyond this distance are ignored (tracer.cl:728).
    t_max: float = 1024.0
    # Rays per device launch = tile_rows * width * sample chunk; the sample
    # loop runs in chunks of this many samples at a time.
    samples_per_pass: int = 8
    # Rows rendered per kernel call (memory chunking; the reference used 4
    # rows per launch to dodge GPU watchdogs, ocltracer.go:215-223 -- here
    # it only bounds memory).
    rows_per_pass: int = 0  # 0 = whole image in one pass
    # RNG seed for the threefry counter-based generator.
    seed: int = 0
    # Terminate the bounce loop once every ray in the batch has died
    # (while_loop). Reverse-mode AD cannot differentiate a dynamic-trip
    # while_loop, so the differentiable path sets this False (fixed
    # fori_loop over max_bounces — identical results, ~2x slower forward).
    early_exit: bool = True
    # Compute backend: "auto" picks the Pallas megakernel when the scene
    # supports it (primitive-only, untextured, f32) and falls back to the
    # wavefront jnp integrator; "pallas"/"wavefront" force one.
    backend: str = "auto"
    # Sample textures through the float atlases so gradients can flow to
    # them (set by the differentiable path, diff/grad.py). The default
    # render path samples the flat rgb8-u32 texel pool (one 4-tap fetch
    # for all sampler kinds; see uv.sample_texture_pool).
    trainable_textures: bool = False
    # Next-event estimation (explicit light sampling with shadow rays).
    # The reference carries this code but ships with the call commented
    # out (tracer.cl:786-829, call site tracer.cl:1168); off by default
    # for estimator parity. Wavefront backend only.
    nee: bool = False
    # Debug probe: print per-bounce path state for one ray index of the
    # batch (-1 = off) — the jax.debug.print equivalent of the reference's
    # hardcoded per-pixel printf probes (tracer.cl:1015, 1065-1067).
    debug_ray: int = -1

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
