"""Loop-mode agreement on scene variants beyond the registered scenes:
the Cornell box with two boxes and with the aluminum box, the three Perlin
display modes, a noise-textured rect, an image on a medium and a two-image
atlas."""
import pytest

from raytracingweekend_tpu.models.scenes import make_scene

import _mode_agreement as ma

VARIANTS = {
    "cornell_two_boxes": lambda: make_scene("cornell_box", 1.0,
                                            glass_sphere=False),
    "cornell_aluminum": lambda: make_scene("cornell_box", 1.0,
                                           glass_sphere=False,
                                           aluminum_box=True),
    "noise_marble": lambda: ma.noise_scene(0),
    "noise_smooth": lambda: ma.noise_scene(1),
    "noise_turb": lambda: ma.noise_scene(2),
    "rect_noise": ma.rect_noise_scene,
    "image_on_medium": ma.image_on_medium_scene,
    "two_image_atlas": ma.two_image_scene,
}


@pytest.mark.parametrize("mode", ["regen", "tiled"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mode_matches_while(variant, mode):
    ma.assert_agrees_with_while(VARIANTS[variant](), mode)
