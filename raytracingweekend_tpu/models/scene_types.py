"""Flat SoA scene representation — the wavefront replacement for the
reference's shared_ptr object graph (reference: hittable.h, hittable_list.h,
sphere.h, material.h, texture.h, Scene/scene.h).

Every hittable in the reference normalizes to a row in one of three padded
tables (spheres, axis rects, constant media); materials and textures are
type-coded rows in their own tables. Instancing wrappers (translate /
rotate_y / flip_normals, hittable.h:269-416) are baked into per-primitive
transform columns — rays are moved into object space per primitive, the same
trick the reference uses (hittable.h:294), but vectorized over the whole
(ray x primitive) wavefront.

All tables are padded to a lane-friendly multiple with `active` masks so
shapes stay static under jit regardless of scene size.
"""
from __future__ import annotations

from typing import Any, Optional

import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass, static_field

# Material type codes (material.h class hierarchy).
MAT_LAMBERTIAN = 0   # material.h:77-122
MAT_METAL = 1        # material.h:124-140
MAT_DIELECTRIC = 2   # material.h:142-225
MAT_DIFFUSE_LIGHT = 3  # material.h:227-247
MAT_ISOTROPIC = 4    # material.h:252-265

# Texture type codes (texture.h class hierarchy).
TEX_CONSTANT = 0  # texture.h:16-27
TEX_CHECKER = 1   # texture.h:29-50
TEX_NOISE = 2     # texture.h:52-71
TEX_IMAGE = 3     # texture.h:73-98

# noise_texture display modes: the active marble formula plus the commented
# alternates preserved at texture.h:59-65.
NOISE_MARBLE = 0  # 0.5*(1+sin(scale*z + 10*turb(p)))   (texture.h:67)
NOISE_SMOOTH = 1  # 0.5*(1+noise(scale*p))              (texture.h:63)
NOISE_TURB = 2    # turb(scale*p)                        (texture.h:65)

# Axis-rect orientation codes (hittable.h:142-267).
RECT_XY = 0  # plane z=k, normal +z
RECT_XZ = 1  # plane y=k, normal +y
RECT_YZ = 2  # plane x=k, normal +x

# Constant-medium boundary kinds.
MEDIUM_SPHERE = 0
MEDIUM_BOX = 1

# Light table kinds.
LIGHT_RECT = 0
LIGHT_SPHERE = 1

# Scene-level static enums (Scene/scene.h:6-16).
RENDER_SHADED = 0
RENDER_NORMAL = 1
BG_BLACK = 0
BG_GRADIENT = 1


@pytree_dataclass
class Spheres:
    """sphere / moving_sphere rows (sphere.h:40-131).

    Static spheres store center1 == center0 (the lerp at sphere.h:22-25 is
    then the identity). Negative radius flips the geometric normal inward —
    used by the hollow glass ball (Scene/scene.h:85-86).
    """
    center0: jnp.ndarray   # (S, 3)
    center1: jnp.ndarray   # (S, 3)
    time0: jnp.ndarray     # (S,)
    time1: jnp.ndarray     # (S,)
    radius: jnp.ndarray    # (S,)
    mat: jnp.ndarray       # (S,) int32
    active: jnp.ndarray    # (S,) bool

    def count(self) -> int:
        return self.radius.shape[0]


@pytree_dataclass
class Rects:
    """Axis-aligned rect rows with baked instancing transform.

    axis selects the (u, v, normal) permutation; `flip` is the flip_normals
    sign (hittable.h:269-292); (cos_t, sin_t, offset) encode the
    translate(rotate_y(rect)) chain of §3.4 in SURVEY.md, identity for
    untransformed rects.
    """
    axis: jnp.ndarray     # (R,) int32 in {RECT_XY, RECT_XZ, RECT_YZ}
    a0: jnp.ndarray       # (R,) first planar extent lo
    a1: jnp.ndarray       # (R,) first planar extent hi
    b0: jnp.ndarray       # (R,) second planar extent lo
    b1: jnp.ndarray       # (R,)
    k: jnp.ndarray        # (R,) plane offset along the normal axis
    flip: jnp.ndarray     # (R,) +-1.0 normal sign
    cos_t: jnp.ndarray    # (R,) rotate_y cos(theta)
    sin_t: jnp.ndarray    # (R,) rotate_y sin(theta)
    offset: jnp.ndarray   # (R, 3) translate offset
    mat: jnp.ndarray      # (R,) int32
    active: jnp.ndarray   # (R,) bool

    def count(self) -> int:
        return self.k.shape[0]


@pytree_dataclass
class Media:
    """constant_medium rows (hittable.h:420-489) with convex analytic
    boundaries (sphere or box), sharing the rect transform encoding."""
    kind: jnp.ndarray      # (V,) int32 in {MEDIUM_SPHERE, MEDIUM_BOX}
    p0: jnp.ndarray        # (V, 3) sphere center / box min
    p1: jnp.ndarray        # (V, 3) (radius,0,0) for sphere / box max
    cos_t: jnp.ndarray     # (V,)
    sin_t: jnp.ndarray     # (V,)
    offset: jnp.ndarray    # (V, 3)
    density: jnp.ndarray   # (V,)
    mat: jnp.ndarray       # (V,) int32
    active: jnp.ndarray    # (V,) bool

    def count(self) -> int:
        return self.density.shape[0]


@pytree_dataclass
class Materials:
    """Type-coded material rows. Colors (albedo / emission) always go through
    the texture table, unifying metal's inline vec3 (material.h:138)."""
    mtype: jnp.ndarray    # (M,) int32
    tex: jnp.ndarray      # (M,) int32 texture index
    fuzz: jnp.ndarray     # (M,) metal fuzz
    ref_idx: jnp.ndarray  # (M,) dielectric refractive index


@pytree_dataclass
class Textures:
    """Type-coded texture rows. Checker children may be any non-checker
    texture (one level of nesting, which covers the reference's usage)."""
    ttype: jnp.ndarray       # (T,) int32
    color: jnp.ndarray       # (T, 3) constant color
    scale: jnp.ndarray       # (T,) noise scale
    noise_mode: jnp.ndarray  # (T,) int32 in {NOISE_MARBLE, NOISE_SMOOTH, NOISE_TURB}
    even: jnp.ndarray        # (T,) int32 checker child
    odd: jnp.ndarray         # (T,) int32 checker child
    image_id: jnp.ndarray    # (T,) int32 index into atlas
    # Image atlas: all image textures padded into one (I, H, W, 3) block.
    images: Optional[jnp.ndarray] = None     # (I, H, W, 3) float32 or None
    image_hw: Optional[jnp.ndarray] = None   # (I, 2) int32 actual (ny, nx)


@pytree_dataclass
class Lights:
    """The MIS lights list (hittable_list used as GetLights(),
    Scene/scene.h:27,35). Rows index into the rect/sphere tables."""
    kind: jnp.ndarray    # (L,) int32 in {LIGHT_RECT, LIGHT_SPHERE}
    index: jnp.ndarray   # (L,) int32 row in the referenced table
    num: int = static_field(0)


@pytree_dataclass
class Camera:
    """Thin-lens look-at camera (camera.h:7-74), precomputed basis."""
    origin: jnp.ndarray            # (3,)
    lower_left_corner: jnp.ndarray # (3,)
    horizontal: jnp.ndarray        # (3,)
    vertical: jnp.ndarray          # (3,)
    u: jnp.ndarray                 # (3,)
    v: jnp.ndarray                 # (3,)
    w: jnp.ndarray                 # (3,)
    lens_radius: jnp.ndarray       # ()
    time0: jnp.ndarray             # ()
    time1: jnp.ndarray             # ()


@pytree_dataclass
class Scene:
    """The full flat scene: geometry + materials + textures + lights + camera.

    Static (non-pytree) fields gate whole code paths at trace time so that a
    scene without e.g. media or noise textures compiles none of that work —
    the jit-era equivalent of the reference's compile-time scene typedef
    (RayTracingWeekend.cpp:199-202).
    """
    spheres: Spheres
    rects: Rects
    media: Media
    materials: Materials
    textures: Textures
    lights: Lights
    camera: Camera
    # Optional acceleration structure over the sphere table (ops/bvh.py
    # SphereBVH pytree; typed Any to avoid a circular import). Built by
    # SceneBuilder.build(use_bvh=True); closest_hit traverses it instead of
    # the brute-force table scan when present (tools/bvh_bench.py times the
    # two).
    bvh: Optional[Any] = None
    background: int = static_field(BG_GRADIENT)
    render_type: int = static_field(RENDER_SHADED)
    # Static capability flags for dead-code elimination under jit.
    has_moving_spheres: bool = static_field(False)
    has_rect_transforms: bool = static_field(False)
    has_media: bool = static_field(False)
    has_noise_tex: bool = static_field(False)
    # Which noise display modes (NOISE_*) the scene's textures actually use;
    # texture evaluation computes only these (marble alone needs 1 turb; all
    # three need 2 turbs + a noise).
    noise_modes: tuple = static_field(())
    has_image_tex: bool = static_field(False)
    has_checker_tex: bool = static_field(False)
    # Material-presence flags: shading evaluates all *present* material
    # branches as masked vector code, so a scene without e.g. dielectrics
    # compiles none of the refraction math (the jit-era analogue of the
    # reference's per-scene compile, RayTracingWeekend.cpp:199-202).
    has_metal: bool = static_field(True)
    has_dielectric: bool = static_field(True)
    has_isotropic: bool = static_field(True)
    has_lights_mat: bool = static_field(True)
    # Diffuse sampling strategy: "mis" is the book-3 final form (cosine pdf
    # mixed with the lights list); the others are the reference's preserved
    # history — the lambertian #if 0 blocks (material.h:83-107):
    # "unit_sphere", "unit_vector", "hemisphere", "onb" — plus the
    # integrator-staging block (RayTracingWeekend.cpp:66-107):
    # "light_only" (hittable_pdf alone, direct light without the mixture).
    lambertian_strategy: str = static_field("mis")
    # True when the packed shading rows (ops/packing.py) cannot express the
    # texture graph (a checker with procedural children) and shading must use
    # the gather-based evaluator. The reference never needs this.
    needs_legacy_textures: bool = static_field(False)
    name: str = static_field("")
