"""Multi-host integration test: a real 2-process jax.distributed cluster.

The reference is strictly single-process (SURVEY.md §5 "Distributed
communication backend": OpenCL queue traffic only); this is the rebuild's
multi-host story under test. Two subprocesses each own 4 virtual CPU
devices, rendezvous through jax.distributed, and render the reference
scene over ONE global (4, 2) pixels x spp mesh via render_sharded — the
same code path a multi-host GPU cluster runs. Every process must gather the
identical full frame, and that frame must be BIT-IDENTICAL to a
single-process render on a local 8-device mesh with the same mesh shape
and seed (the RNG streams are keyed by logical mesh coordinates, not by
process layout).
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

from pathtracer.config import RenderConfig
from pathtracer.parallel import make_mesh
from pathtracer.parallel.render_dist import render_sharded
from pathtracer.scene.pack import pack_scene
from pathtracer.scenes import get_scene


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_cluster_matches_single_process(tmp_path):
    import jax

    root = pathlib.Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(root),
           # the pytest parent exports count=8; each worker must get 4
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    port = _free_port()
    outs = [tmp_path / f"img{i}.npy" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(root / "tests" / "_multihost_worker.py"),
             str(i), "2", str(port), str(outs[i])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(root), env=env,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    img0 = np.load(outs[0])
    img1 = np.load(outs[1])
    # every host gathered the same full frame
    np.testing.assert_array_equal(img0, img1)
    assert img0.shape == (48, 64, 3)
    assert np.isfinite(img0).all() and img0.mean() > 0.01

    # single-process render on the local 8-device mesh, same (4, 2) shape,
    # same seed -> bit-identical (streams keyed by logical coordinates)
    cfg = RenderConfig(width=64, height=48, samples=4, samples_per_pass=2)
    sc = get_scene("reference", cfg)
    arrays, meta = pack_scene(sc.objects)
    mesh = make_mesh(jax.devices(), shape=(4, 2))
    local = render_sharded(arrays, meta, sc.camera, cfg, mesh)
    np.testing.assert_array_equal(img0, local)
