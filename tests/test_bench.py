"""bench.py contract: it measures on a GPU only, always prints one
parseable JSON line, and its measurement functions work end to end (run
here on the CPU at a tiny size, where no number is reported)."""
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _bench(env_extra, timeout=300):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **env_extra}
    return subprocess.run(
        [sys.executable, str(ROOT / "bench.py")],
        capture_output=True, text=True, timeout=timeout, cwd=str(ROOT),
        env=env,
    )


def test_bench_emits_valid_json():
    """Off the card bench.py refuses to measure: exit 1, and the headline
    JSON names the device it found, with value null."""
    res = _bench({"BENCH_BACKEND": "wavefront", "BENCH_SPP": "2",
                  "BENCH_WIDTH": "64", "BENCH_HEIGHT": "48"})
    assert res.returncode == 1, res.stderr[-2000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["unit"] == "Msamples/s"
    assert rec["value"] is None and "GPU" in rec["error"]
    assert rec["device"]["platform"] == "cpu"
    assert rec["device"]["count"] >= 1
    assert "reference_64x48" in rec["metric"]


def test_bench_prints_parseable_line_on_total_failure():
    """An unknown scene fails before any device work, still with the
    headline JSON (value null, error recorded) and exit 1."""
    res = _bench({"BENCH_EXTRA": "0", "BENCH_SCENE": "no-such-scene"})
    assert res.returncode == 1
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["value"] is None
    assert "no-such-scene" in rec["error"]


def test_bench_measure_functions_run():
    """The wavefront and fwd+bwd measurement functions (what bench.py
    times on the card) return a positive sample count and duration."""
    sys.path.insert(0, str(ROOT))
    import bench

    for fn in (bench.bench_wavefront, bench.bench_diff):
        from pathtracer.config import RenderConfig
        from pathtracer.scenes import get_scene

        cfg = RenderConfig(width=8, height=6, samples=2048,
                           samples_per_pass=2)
        sc = get_scene("reference", cfg)
        arrays, meta = sc.pack()
        samples, dt = fn(cfg, sc, arrays, meta, 8)
        assert samples > 0 and dt > 0


def test_bench_device_record():
    import jax

    from pathtracer.device import device_record

    rec = device_record()
    assert rec == {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}
