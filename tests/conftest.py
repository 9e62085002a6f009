"""Test harness: run everything on a virtual 8-device CPU mesh.

JAX is pinned to the CPU before any backend initializes, with 8 virtual
host devices for the mesh tests. Tests marked `gpu` need the card: they
skip here and run on a GPU host through `python chip_smoke.py`, which
sets PT_TESTS_GPU=1 and runs them in its own process on the card.
"""
import os

if os.environ.get("PT_TESTS_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")


# ---------------------------------------------------------------------------
# slow-test profile: tests measured >20 s on the CI box are marked `slow`
# and excluded by the default `-m "not slow"` (pyproject).
# Full profile (CI/nightly): pytest -m 'slow or not slow'
# Regenerate the list from: pytest -q --durations=60 -m 'slow or not slow'
# ---------------------------------------------------------------------------
import pytest  # noqa: E402

_SLOW_TESTS = {
    # training / gradients
    "test_train_demo_recovers_colors",
    "test_sharded_train_step_optax",
    "test_train_state_checkpoint_roundtrip",
    "test_grad_color_finite_difference",
    "test_sharded_train_step",
    "test_grad_exists_and_matches_finite_difference",
    "test_train_step_descends",
    # distributed drivers
    "test_driver_with_mesh_checkpoint_resume",
    "test_driver_with_mesh_matches_local_statistically",
    "test_driver_with_mesh_recovers_from_fault",
    "test_two_process_cluster_matches_single_process",
    # interpret-mode megakernel parity
    "test_textured_megakernel_matches_wavefront[textures-32-0.04]",
    "test_textured_megakernel_matches_wavefront[cubemap-16-0.04]",
    "test_octant_copy_parity",
    "test_teapot_golden",
    "test_scene_goldens[textures]",
    "test_megakernel_nee_multi_light",
    "test_megakernel_nee_mesh_scene",
    "test_megakernel_nee_matches_wavefront_statistically",
    "test_oracle_image_convergence[default]",
    # driver / CLI
    "test_checkpoint_resume_bit_identical",
    "test_fault_recovery_identical_output",
    "test_render_with_profile_and_debug_ray",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """`gpu`-marked tests run only where JAX's default device is a GPU;
    decided per test at run time, never at collection."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
