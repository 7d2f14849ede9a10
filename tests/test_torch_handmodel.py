"""The port's hand model and camera against the JAX reference.

Inputs are numpy arrays made from a seed and handed to both packages.
Tolerance: 1e-5 absolute on sphere coordinates (meters, |x| < 1) — both
sides compute the same float32 expressions, which may differ only in
fusion and FMA contraction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import camera as jcam
from repro.core import handmodel as jhm
from repro_torch.core import camera as tcam
from repro_torch.core import handmodel as thm

CPU = torch.device("cpu")
ATOL = 1e-5


def _configurations(n, seed):
    """(n, 27) configurations in front of the camera, with angles drawn
    past the joint limits so the clip is exercised."""
    rng = np.random.default_rng(seed)
    h = np.zeros((n, 27), np.float32)
    h[:, 0:2] = rng.uniform(-0.1, 0.1, (n, 2))
    h[:, 2] = rng.uniform(0.35, 0.7, n)
    h[:, 3:7] = rng.normal(size=(n, 4))
    h[:, 7:] = rng.uniform(-2.0, 2.5, (n, 20))
    return h


def test_geometry_constants_match_reference():
    for name in ("NUM_PARAMS", "NUM_SPHERES", "NUM_SPHERES_RAW",
                 "NUM_PALM_SPHERES", "NUM_FINGER_SPHERES", "SPHERES_PER_BONE",
                 "NUM_BONES_PER_FINGER", "PALM_WIDTH", "PALM_LENGTH",
                 "PALM_THICKNESS", "_FINGER_BASES", "_BONE_LENGTHS",
                 "_FINGER_RADII", "_FINGER_DIRS", "_ABD_LIMIT", "_FLEX_LO",
                 "_FLEX_HI", "FINGER_NAMES"):
        assert getattr(thm, name) == getattr(jhm, name), name
    for a, b in zip(thm._palm_spheres_local(), jhm._palm_spheres_local()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        thm.angle_lower_bounds(CPU).numpy(), np.asarray(jhm.angle_lower_bounds()))
    np.testing.assert_array_equal(
        thm.angle_upper_bounds(CPU).numpy(), np.asarray(jhm.angle_upper_bounds()))
    # radii do not depend on the pose: compare at the rest pose
    _, r_ref = jhm.hand_spheres_local(jnp.zeros(20))
    _, r_port = thm.hand_spheres_local(torch.zeros(20))
    np.testing.assert_array_equal(r_port.numpy(), np.asarray(r_ref))
    assert float(r_port[thm.NUM_SPHERES_RAW:].abs().max()) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pack_spheres_matches_reference(seed):
    h = _configurations(6, seed)
    ref = np.asarray(jax.vmap(jhm.pack_spheres)(jnp.asarray(h)))
    port = thm.pack_spheres(thm.configuration_from_numpy(h, CPU))
    assert port.shape == (6, thm.NUM_SPHERES, 4) and port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=ATOL)
    # one configuration without a batch axis is the same function
    np.testing.assert_allclose(
        thm.pack_spheres(torch.from_numpy(h[0])).numpy(), ref[0], rtol=0, atol=ATOL)


def test_quaternion_helpers_match_reference():
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(2, 7, 4)).astype(np.float32)
    v = rng.normal(size=(7, 3)).astype(np.float32)
    axis = rng.normal(size=(7, 3)).astype(np.float32)
    angle = rng.uniform(-3, 3, 7).astype(np.float32)
    qa = np.array(jhm.quat_normalize(jnp.asarray(a)))  # writable copy
    pairs = [
        (thm.quat_normalize(torch.from_numpy(a)), qa),
        (thm.quat_multiply(torch.from_numpy(a), torch.from_numpy(b)),
         jhm.quat_multiply(jnp.asarray(a), jnp.asarray(b))),
        (thm.quat_rotate(torch.from_numpy(qa), torch.from_numpy(v)),
         jhm.quat_rotate(jnp.asarray(qa), jnp.asarray(v))),
        (thm.quat_from_axis_angle(torch.from_numpy(axis), torch.from_numpy(angle)),
         jhm.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(angle))),
    ]
    for port, ref in pairs:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_bounds_and_normalization_match_reference():
    h = _configurations(4, 9)
    for center in h:
        c_ref, c_port = jnp.asarray(center), torch.from_numpy(center)
        for kw in ({}, {"pos_range": 0.1, "quat_range": 0.3}):
            np.testing.assert_array_equal(
                thm.parameter_lower_bounds(c_port, **kw).numpy(),
                np.asarray(jhm.parameter_lower_bounds(c_ref, **kw)))
            np.testing.assert_array_equal(
                thm.parameter_upper_bounds(c_port, **kw).numpy(),
                np.asarray(jhm.parameter_upper_bounds(c_ref, **kw)))
    np.testing.assert_allclose(
        thm.normalize_configuration(torch.from_numpy(h)).numpy(),
        np.asarray(jhm.normalize_configuration(jnp.asarray(h))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        thm.default_pose(0.4, device=CPU).numpy(), np.asarray(jhm.default_pose(0.4)))


def test_camera_rays_match_reference():
    for cam_args in ({}, {"width": 40, "height": 24, "fx": 36.0, "fy": 36.0,
                          "cx": 19.5, "cy": 11.5}):
        ref_cam, port_cam = jcam.Camera(**cam_args), tcam.Camera(**cam_args)
        np.testing.assert_array_equal(
            port_cam.rays(CPU).numpy(), np.asarray(ref_cam.rays()))
        assert port_cam.rays_flat(CPU).shape == (port_cam.num_pixels, 3)
        assert float(port_cam.rays_flat(CPU)[:, 2].min()) == 1.0
    for scale in (2, 4):
        assert (tcam.crop_camera(tcam.Camera(), scale).__dict__
                == jcam.crop_camera(jcam.Camera(), scale).__dict__)


def test_hand_geometry_matches_reference():
    """The frozen dataclass of static geometry constants: the same fields
    and defaults as the reference's."""
    import dataclasses

    want, got = jhm.HandGeometry(), thm.HandGeometry()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got == thm.HandGeometry(thm.NUM_SPHERES, thm.PALM_WIDTH, thm.PALM_LENGTH)
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.num_spheres = 0
