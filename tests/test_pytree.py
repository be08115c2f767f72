"""The scene dataclasses as JAX pytrees (utils/pytree.py): flatten /
unflatten round trips, functional `.replace`, and jit specialization on
static fields."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingweekend_tpu.models import scene_types as st
from raytracingweekend_tpu.models.scenes import make_scene
from raytracingweekend_tpu.ops import geometry, materials
from raytracingweekend_tpu.ops.bvh import SphereBVH, build_sphere_bvh
from raytracingweekend_tpu.utils.pytree import pytree_dataclass, static_field


def _hit(n=4):
    z = jnp.zeros((n,))
    return geometry.Hit(hit=z > 0, t=z, p=jnp.zeros((n, 3)),
                        normal=jnp.zeros((n, 3)), u=z, v=z,
                        mat=jnp.zeros((n,), jnp.int32),
                        sattr=jnp.zeros((n, 16)))


def _instances():
    scene = make_scene("cornell_smoke", 1.0)
    earth = make_scene("earth", 1.0)
    return {
        "Spheres": (make_scene("dielectric", 1.0).spheres, "radius"),
        "Rects": (scene.rects, "k"),
        "Media": (scene.media, "density"),
        "Materials": (scene.materials, "fuzz"),
        "Textures": (earth.textures, "images"),
        "Lights": (scene.lights, "index"),
        "Camera": (scene.camera, "origin"),
        "Scene": (scene, "camera"),
        "Hit": (_hit(), "t"),
        "ShadeResult": (materials.ShadeResult(
            direction=jnp.ones((4, 3)), weight=jnp.ones((4, 3)),
            emitted=jnp.zeros((4, 3)), scatter=jnp.ones((4,), bool)),
            "weight"),
        "SphereBVH": (build_sphere_bvh(
            make_scene("random_balls", 1.0).spheres), "skip"),
    }


NAMES = ["Spheres", "Rects", "Media", "Materials", "Textures", "Lights",
         "Camera", "Scene", "Hit", "ShadeResult", "SphereBVH"]
CLASSES = {"Spheres": st.Spheres, "Rects": st.Rects, "Media": st.Media,
           "Materials": st.Materials, "Textures": st.Textures,
           "Lights": st.Lights, "Camera": st.Camera, "Scene": st.Scene,
           "Hit": geometry.Hit, "ShadeResult": materials.ShadeResult,
           "SphereBVH": SphereBVH}


@pytest.mark.parametrize("name", NAMES)
def test_flatten_roundtrip(name):
    obj, _ = _instances()[name]
    assert isinstance(obj, CLASSES[name])
    leaves, treedef = jax.tree.flatten(obj)
    assert leaves and all(hasattr(x, "shape") for x in leaves)
    back = jax.tree.unflatten(treedef, leaves)
    assert type(back) is type(obj)
    for a, b in zip(jax.tree.leaves(back), leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # static fields survive the round trip unchanged
    for f in dataclasses.fields(obj):
        if f.metadata.get("static"):
            assert getattr(back, f.name) == getattr(obj, f.name)


@pytest.mark.parametrize("name", NAMES)
def test_replace_is_functional(name):
    obj, field = _instances()[name]
    new_val = jax.tree.map(lambda x: x + 1 if x.dtype != bool else ~x,
                           getattr(obj, field))
    new = obj.replace(**{field: new_val})
    assert type(new) is type(obj)
    assert getattr(new, field) is new_val
    assert getattr(obj, field) is not new_val      # original untouched
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, field, new_val)


def test_static_fields_are_treedef_not_leaves():
    scene = make_scene("cornell_box", 1.0)
    n = len(jax.tree.leaves(scene))
    other = scene.replace(has_metal=not scene.has_metal, name="x")
    assert len(jax.tree.leaves(other)) == n
    assert (jax.tree.structure(other) != jax.tree.structure(scene))
    lights = scene.lights
    assert jax.tree.structure(lights.replace(num=lights.num + 1)) != \
        jax.tree.structure(lights)


def test_jit_retraces_when_a_static_field_changes():
    traces = []

    @jax.jit
    def f(sc):
        traces.append(sc.render_type)
        return jnp.sum(sc.camera.origin)

    scene = make_scene("cornell_box", 1.0)
    f(scene)
    f(scene.replace(camera=scene.camera.replace(
        origin=scene.camera.origin + 1.0)))       # leaf change: cached
    assert traces == [st.RENDER_SHADED]
    f(scene.replace(render_type=st.RENDER_NORMAL))  # static change: retrace
    assert traces == [st.RENDER_SHADED, st.RENDER_NORMAL]


def test_pytree_dataclass_helper():
    @pytree_dataclass
    class Pair:
        a: jnp.ndarray
        tag: str = static_field("t")

    p = Pair(jnp.arange(3))
    leaves, treedef = jax.tree.flatten(p)
    assert len(leaves) == 1
    q = jax.jit(lambda x: x.replace(a=x.a * 2))(p)
    assert q.tag == "t"
    np.testing.assert_array_equal(np.asarray(q.a), [0, 2, 4])
