"""Wavefront material shading — scatter/emitted/scattering_pdf as masked
vector branches (reference: material.h).

The reference dispatches virtually per hit; here all five material types are
evaluated as fused masked vector code over the whole wavefront and selected by
type code. The lambertian branch carries the book-3 one-sample-MIS weighting
(sampled pdf = mixture, numerator = BRDF-shaped scattering_pdf — SURVEY.md
§3.2); metal/dielectric/isotropic are the reference's "specular" pdf_ptr ==
nullptr path (material.h:51-57, RayTracingWeekend.cpp:114-115).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..models import scene_types as st
from ..utils.pytree import pytree_dataclass
from . import linalg, packing, pdfs, sampling, textures
from .geometry import Hit


def _eval_texture_packed(sh, u, v, p, scene: st.Scene):
    """texture::value over the packed shading rows (ops/packing.py) —
    gather-free except the image atlas lookup. sh: (N, 16) -> (N, 3)."""
    ttype = sh[:, packing.S_TTYPE]
    out = sh[:, packing.S_COL:packing.S_COL + 3]
    if scene.has_checker_tex:
        # sign of sin(10x)sin(10y)sin(10z) picks the child (texture.h:35-46);
        # child colors are baked constants (the only form the reference uses).
        sines = (jnp.sin(10.0 * p[..., 0]) * jnp.sin(10.0 * p[..., 1])
                 * jnp.sin(10.0 * p[..., 2]))
        cval = jnp.where(sines[:, None] < 0,
                         sh[:, packing.S_ODD:packing.S_ODD + 3],
                         sh[:, packing.S_EVEN:packing.S_EVEN + 3])
        out = jnp.where((ttype == st.TEX_CHECKER)[:, None], cval, out)
    if scene.has_noise_tex:
        from . import noise as noise_mod
        scale = sh[:, packing.S_SCALE]
        mode = sh[:, packing.S_NMODE]
        modes = scene.noise_modes or (st.NOISE_MARBLE, st.NOISE_SMOOTH,
                                      st.NOISE_TURB)
        nval = jnp.zeros(p.shape[:-1], p.dtype)
        if st.NOISE_MARBLE in modes:
            marble = 0.5 * (1.0 + jnp.sin(scale * p[..., 2]
                                          + 10.0 * noise_mod.turb(p)))
            nval = jnp.where(mode == st.NOISE_MARBLE, marble, nval)
        if st.NOISE_SMOOTH in modes:
            smooth = 0.5 * (1.0 + noise_mod.noise(p * scale[..., None]))
            nval = jnp.where(mode == st.NOISE_SMOOTH, smooth, nval)
        if st.NOISE_TURB in modes:
            turbv = noise_mod.turb(p * scale[..., None])
            nval = jnp.where(mode == st.NOISE_TURB, turbv, nval)
        out = jnp.where((ttype == st.TEX_NOISE)[:, None], nval[:, None], out)
    if scene.has_image_tex and scene.textures.images is not None:
        img_id = sh[:, packing.S_IMG].astype(jnp.int32)
        hw = scene.textures.image_hw[img_id]
        ny = hw[..., 0]
        nx = hw[..., 1]
        i = jnp.clip((u * nx).astype(jnp.int32), 0, nx - 1)
        j = jnp.clip(((1.0 - v) * ny - 0.001).astype(jnp.int32), 0, ny - 1)
        ival = scene.textures.images[img_id, j, i]
        out = jnp.where((ttype == st.TEX_IMAGE)[:, None], ival, out)
    return out


@pytree_dataclass
class ShadeResult:
    direction: jnp.ndarray  # (N, 3) next ray direction (may be unnormalized)
    weight: jnp.ndarray     # (N, 3) throughput multiplier for this vertex
    emitted: jnp.ndarray    # (N, 3) radiance emitted at this vertex
    scatter: jnp.ndarray    # (N,) bool — path continues


def shade(key, d_in, hit: Hit, scene: st.Scene) -> ShadeResult:
    """One shading step for N rays at their hit points.

    Implements the Shaded branch of color() (RayTracingWeekend.cpp:56-133):
    emitted + attenuation * scattering_pdf * L(next) / pdf_val for pdf
    materials, attenuation * L(next) for specular ones.
    """
    N = d_in.shape[0]
    # Miss lanes carry p = o + BIG*d (~1e37). Squaring that overflows to
    # inf and yields primal NaNs downstream (0/0 in the light-cone ONB
    # normalize, inf-inf in rect light pdfs, sin(1e37) in procedural
    # textures). The forward results are masked out, but reverse-mode VJPs
    # multiply by primal values, so ONE such lane poisons every scene
    # gradient (jax.grad -> NaN in any lights-list scene). Zeroing the
    # dead lanes' shading point is invisible to the masked forward and
    # keeps autodiff finite.
    hit = hit.replace(p=jnp.where(hit.hit[:, None], hit.p, 0.0))
    if hit.sattr is not None and not scene.needs_legacy_textures:
        # packed fast path: zero material-table gathers (ops/packing.py)
        mtype = hit.sattr[:, packing.S_MTYPE].astype(jnp.int32)
        fuzz_all = hit.sattr[:, packing.S_FUZZ]
        ref_idx_all = hit.sattr[:, packing.S_RIDX]
        tex_val = _eval_texture_packed(hit.sattr, hit.u, hit.v, hit.p, scene)
    else:
        mats = scene.materials
        mtype = mats.mtype[hit.mat]
        fuzz_all = mats.fuzz[hit.mat]
        ref_idx_all = mats.ref_idx[hit.mat]
        tex_val = textures.eval_texture(mats.tex[hit.mat], hit.u, hit.v,
                                        hit.p, scene)

    k_mix, k_fuzz, k_diel, k_iso = jax.random.split(key, 4)

    # --- emission (diffuse_light::emitted, material.h:238-244) ---
    # One-sided: emits only when the ray direction agrees with the normal.
    # Scene-level material-presence flags compile absent branches away.
    if scene.has_lights_mat:
        facing = linalg.dot(hit.normal, d_in) > 0
        is_light = mtype == st.MAT_DIFFUSE_LIGHT
        emitted = jnp.where((is_light & facing)[:, None], tex_val, 0.0)
    else:
        is_light = jnp.zeros((N,), bool)
        emitted = jnp.zeros((N, 3), d_in.dtype)

    # --- lambertian: cosine pdf + MIS mixture (material.h:77-122), or one
    # of the reference's four preserved historical strategies
    # (material.h:83-107 #if 0 blocks), selected statically per scene ---
    strategy = scene.lambertian_strategy
    if strategy == "mis":
        mix_dir, pdf_val = pdfs.mixture_sample_and_value(k_mix, hit.p,
                                                         hit.normal, scene)
    elif strategy == "unit_sphere":
        # target = p + normal + random_in_unit_sphere (material.h:83-87);
        # sampled from the scattering pdf only in aggregate — the reference
        # sets sampling_pdf = scattering_pdf, cancelling the weight.
        mix_dir = hit.normal + sampling.random_in_unit_sphere(
            k_mix, (N,))
        pdf_val = None  # weight cancels to the albedo
    elif strategy == "unit_vector":
        # target = p + normal + random_unit_vector (material.h:89-93)
        mix_dir = hit.normal + sampling.random_unit_vector(k_mix, (N,))
        pdf_val = None
    elif strategy == "hemisphere":
        # uniform hemisphere, pdf 1/(2 pi) (material.h:95-99)
        mix_dir = sampling.random_in_hemisphere(k_mix, hit.normal)
        pdf_val = jnp.full((N,), 1.0 / (2.0 * math.pi), d_in.dtype)
    elif strategy == "onb":
        # cosine pdf about the normal, no light mixture (material.h:101-107)
        mix_dir = pdfs.cosine_pdf_sample(k_mix, hit.normal)
        pdf_val = pdfs.cosine_pdf_value(hit.normal, mix_dir)
    elif strategy == "light_only":
        # the book-3 ch.10 integrator stage preserved in the reference's
        # #if 0 history (RayTracingWeekend.cpp:66-107): sample the lights
        # list ALONE — hittable_pdf without the cosine mixture. Noise-free
        # direct light, black indirect (pdf 0 off-light directions), the
        # stepping stone the final mixture_pdf stage fixes.
        assert scene.lights.num > 0, "light_only needs a lights list"
        mix_dir = pdfs.lights_sample(k_mix, hit.p, scene)
        pdf_val = pdfs.lights_pdf_value(hit.p, mix_dir, scene)
    else:  # pragma: no cover
        raise ValueError(f"unknown lambertian_strategy {strategy!r}")
    cosine = linalg.dot(hit.normal, linalg.normalize(mix_dir))
    spdf = jnp.where(cosine < 0, 0.0, cosine / math.pi)  # material.h:115-119
    if pdf_val is None:
        # sampling_pdf == scattering_pdf by construction: weight = albedo
        # whenever the sampled direction is above the horizon.
        lam_ok = spdf > 0.0
        lam_weight = jnp.where(lam_ok[:, None], tex_val, 0.0)
    else:
        lam_ok = pdf_val > 0.0  # cpp:126-127 pdf_val <= 0 -> return emitted
        lam_weight = jnp.where(
            lam_ok[:, None],
            tex_val * (spdf / jnp.where(lam_ok, pdf_val, 1.0))[:, None],
            0.0)

    # --- metal (material.h:124-140) ---
    if scene.has_metal:
        reflected_unit = linalg.reflect(linalg.normalize(d_in), hit.normal)
        metal_dir = (reflected_unit
                     + fuzz_all[:, None] * sampling.random_in_unit_sphere(
                         k_fuzz, (N,)))
    else:
        metal_dir = d_in

    # --- dielectric (material.h:142-225) ---
    if scene.has_dielectric:
        ref_idx = ref_idx_all
        d_dot_n = linalg.dot(d_in, hit.normal)
        d_len = linalg.length(d_in)
        inside = d_dot_n > 0
        outward_normal = jnp.where(inside[:, None], -hit.normal, hit.normal)
        ni_over_nt = jnp.where(inside, ref_idx, 1.0 / ref_idx)
        # Schlick cosine: the author's corrected larger-angle form when
        # exiting (material.h:160-183), plain cosine when entering.
        ct = d_dot_n / d_len
        cos_exit = linalg.safe_sqrt(1.0 - ref_idx * ref_idx * (1.0 - ct * ct))
        cosine = jnp.where(inside, cos_exit, -ct)
        reflected = linalg.reflect(d_in, hit.normal)  # unnormalized (:194)
        refracted, can_refract = linalg.refract(d_in, outward_normal,
                                                ni_over_nt)
        reflect_prob = jnp.where(can_refract,
                                 linalg.schlick(cosine, ref_idx), 1.0)
        coin = sampling.uniform(k_diel, (N,)) < reflect_prob
        diel_dir = jnp.where(coin[:, None], reflected, refracted)
    else:
        diel_dir = d_in

    # --- isotropic (material.h:252-265) ---
    iso_dir = (sampling.random_in_unit_sphere(k_iso, (N,))
               if scene.has_isotropic else d_in)

    # --- select by material type ---
    is_lam = mtype == st.MAT_LAMBERTIAN
    is_metal = mtype == st.MAT_METAL
    is_diel = mtype == st.MAT_DIELECTRIC
    is_iso = mtype == st.MAT_ISOTROPIC

    direction = jnp.where(
        is_lam[:, None], mix_dir,
        jnp.where(is_metal[:, None], metal_dir,
                  jnp.where(is_diel[:, None], diel_dir, iso_dir)))
    ones = jnp.ones_like(tex_val)
    weight = jnp.where(
        is_lam[:, None], lam_weight,
        jnp.where(is_diel[:, None], ones,                 # attenuation (1,1,1)
                  jnp.where((is_metal | is_iso)[:, None], tex_val, 0.0)))
    scatter = jnp.where(is_lam, lam_ok, ~is_light)
    # Reparameterized sampling: the raw uniform draws are parameter-free, so
    # the sampled direction is differentiable through the ONB frame / normals
    # / Snell's law, matching what fixed-key finite differences measure; only
    # discrete decisions (coins, branch selects) have zero gradient.
    return ShadeResult(direction=direction, weight=weight, emitted=emitted,
                       scatter=scatter)
