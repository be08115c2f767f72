"""Wavefront FD gradient checks for geometric parameters: camera origin,
sphere centre through the lights-MIS path, and medium density."""
import numpy as np
import pytest

from _fd import density_scene, grad_and_fd, mis_scene


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_camera_origin(axis):
    """Moving the origin shifts every primary ray; eps is small enough
    that no silhouette winner flips for this seed."""
    g, fd = grad_and_fd(
        mis_scene(), lambda s: s.camera.origin,
        lambda s, p: s.replace(camera=s.camera.replace(origin=p)),
        (axis,), eps=3e-3, seed=0)
    np.testing.assert_allclose(g, fd, rtol=3e-2, atol=1e-5)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sphere_center_through_mis(axis):
    g, fd = grad_and_fd(
        mis_scene(), lambda s: s.spheres.center0,
        lambda s, p: s.replace(spheres=s.spheres.replace(center0=p,
                                                         center1=p)),
        (0, axis), eps=5e-4, seed=1)
    np.testing.assert_allclose(g, fd, rtol=3e-2, atol=1e-5)


def test_medium_density():
    g, fd = grad_and_fd(
        density_scene(), lambda s: s.media.density,
        lambda s, p: s.replace(media=s.media.replace(density=p)),
        (0,), eps=1e-4, seed=0)
    assert abs(fd) > 1e-3
    np.testing.assert_allclose(g, fd, rtol=3e-2, atol=1e-6)
