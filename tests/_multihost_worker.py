"""Worker process for the multi-host integration test.

Launched N times by tests/test_multihost.py; each instance joins the
jax.distributed cluster as one "host" with 4 virtual CPU devices, renders
the reference scene over the GLOBAL (4, 2) mesh via render_sharded, and
writes the image it gathered (every process gathers the full image —
that's the production contract: each host ends up with the final frame).

Usage: python tests/_multihost_worker.py <proc_id> <n_proc> <port> <out.npy>
"""
import os
import sys

proc_id, n_proc, port, out_path = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])

# a CPU "host" with 4 virtual devices; both must be set before JAX
# initializes a backend
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

from pathtracer.parallel.multihost import (  # noqa: E402
    initialize_multihost,
)

# must run before ANY backend-initializing jax call (jax.devices etc.)
initialize_multihost(
    coordinator_address=f"localhost:{port}",
    num_processes=n_proc,
    process_id=proc_id,
)

from pathtracer.config import RenderConfig  # noqa: E402
from pathtracer.parallel import make_mesh  # noqa: E402
from pathtracer.parallel.render_dist import render_sharded  # noqa: E402
from pathtracer.scene.pack import pack_scene  # noqa: E402
from pathtracer.scenes import get_scene  # noqa: E402
assert jax.process_count() == n_proc, jax.process_count()
assert jax.local_device_count() == 4, jax.local_device_count()
assert jax.device_count() == 4 * n_proc, jax.device_count()

cfg = RenderConfig(width=64, height=48, samples=4, samples_per_pass=2)
sc = get_scene("reference", cfg)
arrays, meta = pack_scene(sc.objects)
mesh = make_mesh(jax.devices(), shape=(4, 2))

img = render_sharded(arrays, meta, sc.camera, cfg, mesh)

import numpy as np  # noqa: E402

np.save(out_path, img)
print(f"worker {proc_id}: wrote {out_path} mean={float(img.mean()):.6f}")
