"""Loop-mode agreement on the rect, light, medium and image-texture
reference scenes: "regen" and "tiled" vs the lockstep "while" loop."""
import pytest

from raytracingweekend_tpu.models.scenes import make_scene

from _mode_agreement import assert_agrees_with_while


@pytest.mark.parametrize("mode", ["regen", "tiled"])
@pytest.mark.parametrize("name", ["light_sample", "cornell_box",
                                  "cornell_smoke", "earth", "earth_rect"])
def test_mode_matches_while(name, mode):
    assert_agrees_with_while(make_scene(name, 1.0), mode)
