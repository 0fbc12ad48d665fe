"""Test configuration: the local CPU backend with 8 virtual devices, so the
multi-device sharding paths run without hardware.

The ``test_scene*`` fixtures load the cornell box from the course-format
files in ``tests/data`` (written by models.procedural.write_cornell_files),
so the XML/OBJ/MTL parsers run on every scene load. Tests that need the
reference repository's own assets (golden renders, veach-mis, staircase)
take the ``reference_scenes`` fixture, which skips them when those files
are absent.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# the reference repository's example-scenes-cg22 directory, when available
SCENES = os.environ.get("TINYPT_REFERENCE_SCENES", "")


@pytest.fixture(scope="session")
def reference_scenes():
    """Directory of the reference's example scenes; skips when missing."""
    if not SCENES or not os.path.isdir(SCENES):
        pytest.skip("reference example scenes not available "
                    "(set TINYPT_REFERENCE_SCENES)")
    return SCENES


@pytest.fixture(scope="session")
def test_scene_paths():
    return dict(
        basedir=DATA,
        xml=os.path.join(DATA, "cornell.xml"),
        obj=os.path.join(DATA, "cornell.obj"),
        mtl=os.path.join(DATA, "cornell.mtl"),
    )


@pytest.fixture(scope="session")
def test_scene(test_scene_paths):
    from tinyraytracing_tpu.models.scene import load_scene

    p = test_scene_paths
    return load_scene(p["xml"], p["obj"], p["mtl"], p["basedir"])


@pytest.fixture(scope="session")
def test_scene_bvh(test_scene_paths):
    from tinyraytracing_tpu.models.scene import load_scene

    p = test_scene_paths
    return load_scene(p["xml"], p["obj"], p["mtl"], p["basedir"], with_bvh=True)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none. This suite
    forces the CPU backend, so on the card the same checks run through
    chip_smoke.py (phase 4)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU")
    return gpus[0]
