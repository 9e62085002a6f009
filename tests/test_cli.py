"""CLI surface tests (cmd/pt/main.go parity): registry listing, arg
parsing, env overrides. Render paths are covered by the driver tests;
these stay subprocess-cheap."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, env=None):
    e = dict(os.environ, JAX_PLATFORMS="cpu")
    e.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "pathtracer", *args],
        capture_output=True, text=True, cwd=REPO, env=e, timeout=120,
    )


def test_list_scenes():
    r = _run("--list-scenes")
    assert r.returncode == 0
    for name in ("reference", "teapot", "gopher", "cubemap",
                 "transparent_teapot"):
        assert name in r.stdout


def test_unknown_scene_errors():
    r = _run("--scene", "nonexistent", "--width", "8", "--height", "8")
    assert r.returncode != 0
    assert "nonexistent" in (r.stdout + r.stderr)


def test_parser_flags():
    from pathtracer.cli import build_parser

    p = build_parser()
    # reference flag set (cmd/pt/main.go:48-56)
    a = p.parse_args([
        "--width", "640", "--height", "480", "--samples", "16",
        "--aperture", "0.1", "--focal-length", "1.5",
        "--scene", "teapot", "--device-index", "0",
    ])
    assert (a.width, a.height, a.samples) == (640, 480, 16)
    assert a.aperture == 0.1 and a.focal_length == 1.5


def test_env_overrides(monkeypatch):
    monkeypatch.setenv("PT_WIDTH", "321")
    monkeypatch.setenv("PT_SCENE", "gopher")
    import importlib

    from pathtracer import cli

    importlib.reload(cli)
    a = cli.build_parser().parse_args([])
    assert a.width == 321
    assert a.scene == "gopher"


def test_render_with_profile_and_debug_ray(tmp_path):
    """--profile writes a jax.profiler trace; --debug-ray prints the
    per-bounce probe (the reference's printf-by-pixel equivalent,
    tracer.cl:1015)."""
    prof = tmp_path / "prof"
    out = tmp_path / "probe.png"
    r = _run("--scene", "reference", "--width", "16", "--height", "12",
             "--samples", "2", "--samples-per-pass", "2",
             "--profile", str(prof), "--debug-ray", "5",
             "--output", str(out))
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists()
    # profiler dumps at least one trace artifact under the directory
    assert any(prof.rglob("*")), "no profiler trace written"
    assert "bounce" in (r.stdout + r.stderr), "debug-ray probe missing"


def test_render_with_nee(tmp_path):
    out = tmp_path / "nee.png"
    r = _run("--scene", "reference", "--width", "16", "--height", "12",
             "--samples", "2", "--samples-per-pass", "2", "--nee",
             "--output", str(out))
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists()
