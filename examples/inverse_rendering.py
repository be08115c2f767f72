"""Inverse rendering demos: recover scene parameters by gradient descent.

The reference renderer has no gradient story; this is the capability the
rebuild adds (BASELINE.md). Two stages, both descending the pixel L2
loss through the differentiable scan-mode integrator with Adam:

1. material colors — a target is rendered with known albedos, the albedos
   are scrambled, and the optimizer recovers them;
2. light GEOMETRY — an emissive sphere sits outside the frame; only the
   shading it casts is visible, and the optimizer recovers the light's
   x/z position and emission color from that shading alone (gradients
   flow through the MIS light-sampling cone and pdf — geometry params,
   not just colors).

Run:  python examples/inverse_rendering.py  (CPU-friendly: a few minutes)
Outputs target / initial / fitted PNGs next to this script.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from raytracingweekend_tpu.models import scene_types as st
from raytracingweekend_tpu.models.builder import SceneBuilder
from raytracingweekend_tpu.grad import (render_diff, fit_texture_colors,
                                        fit_scene_params)
from raytracingweekend_tpu.utils import image as image_mod

HERE = os.path.dirname(os.path.abspath(__file__))
KEY = jax.random.key(0)
NX = NY = 48
SPP = 24
DEPTH = 5


def build(colors):
    b = SceneBuilder()
    b.sphere((-1.1, 0.0, -3.0), 0.9, b.lambertian(b.constant(colors[0])))
    b.sphere((1.1, 0.0, -3.0), 0.9, b.lambertian(b.constant(colors[1])))
    b.sphere((0.0, -100.9, -3.0), 100.0, b.lambertian(b.constant(colors[2])))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 60.0, NX / NY, 0.0, 1.0)
    return b.build(background=st.BG_GRADIENT)


def save(img, name):
    path = os.path.join(HERE, name)
    image_mod.write_png(image_mod.postprocess(np.asarray(img)), path)
    print("wrote", path)


def build_light_scene(light_center, emit):
    """Diffuse spheres lit by an OFF-FRAME emissive sphere: only its cast
    shading is visible. Negative radius -> inward normals (the reference's
    one-sided emission, material.h:240, requires a sphere light to face
    inward-out)."""
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -3.0), 0.8, b.lambertian(b.constant((0.5, 0.5, 0.5))))
    b.sphere((0, -100.8, -3.0), 100.0,
             b.lambertian(b.constant((0.6, 0.6, 0.6))))
    h = b.sphere(tuple(light_center), -1.0,
                 b.diffuse_light(b.constant(tuple(emit))))
    b.add_light(h)
    b.camera((0, 0.2, 0.6), (0, 0, -3), (0, 1, 0), 45.0, NX / NY, 0.0, 1.0)
    return b.build(background=st.BG_BLACK)


def fit_light(steps=150, lr=0.05):
    """Stage 2: recover the light's x/z position + emission color from the
    shading it casts (y is pinned: height trades off against intensity)."""
    true_c = np.array([1.2, 2.6, -2.2], np.float32)
    true_e = np.array([6.0, 4.8, 3.6], np.float32)
    target_scene = build_light_scene(true_c, true_e)
    target = render_diff(target_scene, KEY, NX, NY, SPP, 3)
    save(target, "inverse_light_target.png")
    start = build_light_scene((-1.0, 2.6, -3.5), (4.0, 4.0, 4.0))
    save(render_diff(start, KEY, NX, NY, SPP, 3), "inverse_light_start.png")
    # the light is sphere slot 2 and its emission texture index 2
    lt = 2

    def get_params(sc):
        return {"c": sc.spheres.center0[lt], "e": sc.textures.color[lt]}

    def set_params(sc, p):
        c = p["c"].at[1].set(2.6)          # pin height
        c0 = sc.spheres.center0.at[lt].set(c)
        c1 = sc.spheres.center1.at[lt].set(c)
        col = sc.textures.color.at[lt].set(p["e"])
        return sc.replace(spheres=sc.spheres.replace(center0=c0, center1=c1),
                          textures=sc.textures.replace(color=col))

    fitted, loss = fit_scene_params(
        start, target, get_params=get_params, set_params=set_params,
        key=KEY, nx=NX, ny=NY, spp=SPP, max_depth=3, steps=steps, lr=lr,
        postprocess=lambda p: {"c": p["c"], "e": jnp.clip(p["e"], 0.0, None)},
        log_fn=lambda i, l, g: print(f"  step {i:3d} loss {l:.3e}")
        if i % 30 == 0 else None)
    save(render_diff(fitted, KEY, NX, NY, SPP, 3), "inverse_light_fitted.png")
    print("recovered light center", np.round(fitted.spheres.center0[lt], 3),
          "(true", true_c, ")")
    print("recovered emission    ", np.round(fitted.textures.color[lt], 3),
          "(true", true_e, ")")
    print(f"final per-step loss {loss:.3e}")


def main():
    true_colors = [(0.8, 0.2, 0.2), (0.2, 0.3, 0.8), (0.6, 0.6, 0.1)]
    target_scene = build(true_colors)
    target = render_diff(target_scene, KEY, NX, NY, SPP, DEPTH)
    save(target, "inverse_target.png")

    start = build([(0.5, 0.5, 0.5)] * 3)
    save(render_diff(start, KEY, NX, NY, SPP, DEPTH), "inverse_start.png")

    fitted, loss = fit_texture_colors(
        start, target, key=KEY, nx=NX, ny=NY, spp=SPP, max_depth=DEPTH,
        steps=80, lr=0.08,
        log_fn=lambda i, l: print(f"  step {i:3d} loss {l:.3e}")
        if i % 20 == 0 else None)
    save(render_diff(fitted, KEY, NX, NY, SPP, DEPTH), "inverse_fitted.png")

    got = np.asarray(fitted.textures.color[:3])
    print("recovered colors:")
    for g, t in zip(got, true_colors):
        print(f"  {np.round(g, 3)}  (true {t})")
    print(f"final per-step loss {loss:.3e}")

    print("stage 2: recover an off-frame light's position + emission")
    fit_light()


if __name__ == "__main__":
    main()
