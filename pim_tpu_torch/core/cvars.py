"""The engine cvar registry — all tunables in one place.

Mirrors the reference's single-registry design (src/common/cvars.c, 55 cvars)
with the same names, defaults, and ranges where the concept survives the TPU
redesign.  Window/input/audio/UI cvars are dropped (headless); TPU-specific
knobs (pt_max_bounces, pt_tile, backend selection) are added.
"""

from __future__ import annotations

from pim_tpu_torch.core.cvar import CVarFlag, CVarType, cvar

SAVE = CVarFlag.SAVE

# --- io / app -------------------------------------------------------------
cv_basedir = cvar("basedir", CVarType.Text, "data", "base directory for game data")
cv_game = cvar("game", CVarType.Text, "id1", "name of the game folder")
cv_con_logpath = cvar("con_logpath", CVarType.Text, "", "console log file path ('' = off)")

# --- renderer -------------------------------------------------------------
cv_r_fov = cvar("r_fov", CVarType.Float, 90.0, "vertical field of view, degrees", 1.0, 170.0, SAVE)
cv_r_znear = cvar("r_znear", CVarType.Float, 0.1, "near clip plane", 0.01, 1.0, SAVE)
cv_r_zfar = cvar("r_zfar", CVarType.Float, 500.0, "far clip plane", 1.0, 1000.0, SAVE)
cv_r_whitepoint = cvar("r_whitepoint", CVarType.Float, 1.2, "tonemap whitepoint", 1.0, 5.0, SAVE)
cv_r_scale = cvar("r_scale", CVarType.Float, 1.0, "render scale", 1.0 / 16.0, 4.0, SAVE)
cv_r_width = cvar("r_width", CVarType.Int, 1920, "render width", 1, 16384, SAVE)
cv_r_height = cvar("r_height", CVarType.Int, 1080, "render height", 1, 16384, SAVE)
cv_r_bumpiness = cvar("r_bumpiness", CVarType.Float, 1.0, "normal map bumpiness", 0.0, 2.0, SAVE)
cv_r_brdflut_spf = cvar("r_brdflut_spf", CVarType.Int, 10, "BRDF LUT samples per frame", 1, 1 << 20)

# --- path tracer ----------------------------------------------------------
cv_pt_trace = cvar("pt_trace", CVarType.Bool, False, "enable path tracing")
cv_pt_denoise = cvar("pt_denoise", CVarType.Bool, False, "denoise path-traced output")
cv_pt_normal = cvar("pt_normal", CVarType.Bool, False, "output the normal AOV")
cv_pt_albedo = cvar("pt_albedo", CVarType.Bool, False, "output the albedo AOV")
cv_pt_dist_meters = cvar(
    "pt_dist_meters", CVarType.Float, 1.5, "light-grid meters per cell", 0.1, 20.0, SAVE
)
cv_pt_max_bounces = cvar(
    "pt_max_bounces", CVarType.Int, 10,
    "wavefront bounce-scan depth (ref uses 666 w/ Russian roulette; "
    "RR keeps expected throughput identical at lower caps)", 1, 666, SAVE,
)
cv_pt_nee = cvar("pt_nee", CVarType.Bool, True, "next-event estimation on/off")
cv_pt_media = cvar("pt_media", CVarType.Bool, False, "heterogeneous participating media")
cv_pt_spp = cvar(
    "pt_spp", CVarType.Int, 1,
    "samples per progressive frame step (batched inside one compiled "
    "step; amortizes per-dispatch host latency).  The batch is the mean "
    "of pt_spp samples drawn under the BATCH-START adapted light pdf and "
    "exposure state — light/exposure adaptation runs once per batch, so "
    "pt_spp=4 is not statistically identical to 4 sequential 1-spp "
    "steps; gate bands must be calibrated at the pt_spp used",
    1, 64, SAVE,
)
cv_pt_seed = cvar(
    "pt_seed", CVarType.Int, 0x9E3779B9,
    "base seed of the per-ray rng streams (ref: per-thread Prng seeding, "
    "random.c:67); calibration varies it for independent runs",
    0, 0xFFFFFFFF,
)
cv_pt_debug = cvar(
    "pt_debug", CVarType.Bool, False,
    "checkify the frame step: NaN/inf and bad-index guards with loud "
    "errors (ref analog: ASSERT density + FTZ determinism, task.c:73-74)",
)
cv_pt_backend = cvar(
    "pt_backend", CVarType.Text, "auto",
    "intersector backend: auto | brute | bvh | pallas",
)
cv_pt_sort = cvar(
    "pt_sort", CVarType.Text, "auto",
    "coherence-sort wavefronts before cluster traces: auto | 0 | 1 "
    "(auto = cluster backend on TPU; render/raysort.py)",
)

cv_prof_trace = cvar(
    "prof_trace", CVarType.Bool, False,
    "program tracing (core/profiler.py): pt.* spans and device counters, "
    "listed with the marks in the report at shutdown",
)

cv_r_tonemap_fit = cvar(
    "r_tonemap_fit", CVarType.Bool, False,
    "screenshot tonemap via the cached rational curve fit (cubic_fit "
    "TMap model) instead of the exact GT operator",
)

# --- reflections / sky ----------------------------------------------------
cv_r_refl_gen = cvar("r_refl_gen", CVarType.Bool, False, "progressive reflection probe bake")
cv_r_sun_dir = cvar(
    "r_sun_dir", CVarType.Vector, (0.882, 0.195, 0.429, 0.0), "sun direction", flags=SAVE
)
cv_r_sun_lum = cvar(
    "r_sun_lum", CVarType.Float, 3800.0, "sun luminance", 2.0**-10, 2.0**31, SAVE
)
cv_r_sun_res = cvar("r_sun_res", CVarType.Int, 64, "sky cubemap resolution", 4, 1024, SAVE)
cv_r_sun_steps = cvar("r_sun_steps", CVarType.Int, 4, "sky raymarch steps", 1, 64, SAVE)
cv_r_qlights = cvar("r_qlights", CVarType.Bool, False, "enable quake light entities")

# --- exposure -------------------------------------------------------------
cv_exp_standard = cvar("exp_standard", CVarType.Bool, False, "standard (vs saturation) exposure")
cv_exp_manual = cvar("exp_manual", CVarType.Bool, False, "manual exposure")
cv_exp_aperture = cvar("exp_aperture", CVarType.Float, 1.4, "aperture f-stops", 1.4, 22.0, SAVE)
cv_exp_shutter = cvar("exp_shutter", CVarType.Float, 0.1, "shutter seconds", 0.001, 1.0, SAVE)
cv_exp_adaptrate = cvar("exp_adaptrate", CVarType.Float, 1.0, "adaptation rate", 0.1, 10.0, SAVE)
cv_exp_evoffset = cvar("exp_evoffset", CVarType.Float, 0.0, "EV offset", -10.0, 10.0, SAVE)
cv_exp_evmin = cvar("exp_evmin", CVarType.Float, -10.0, "min EV", -23.0, 23.0, SAVE)
cv_exp_evmax = cvar("exp_evmax", CVarType.Float, 23.0, "max EV", -23.0, 23.0, SAVE)
cv_exp_cdfmin = cvar("exp_cdfmin", CVarType.Float, 0.1, "histogram cdf min", 0.0, 1.0, SAVE)
cv_exp_cdfmax = cvar("exp_cdfmax", CVarType.Float, 0.9, "histogram cdf max", 0.0, 1.0, SAVE)

# --- sky medium (physical atmosphere; ref: src/common/cvars.c:415-478) ----
cv_sky_rad_cr = cvar("sky_rad_cr", CVarType.Float, 6360.0, "planet crust radius, km", 636.0, 63600.0, SAVE)
cv_sky_rad_at = cvar("sky_rad_at", CVarType.Float, 60.0, "atmosphere thickness, km", 6.0, 600.0, SAVE)
cv_sky_rlh_mfp = cvar("sky_rlh_mfp", CVarType.Vector, (192.0, 82.0, 34.0, 0.0), "rayleigh mfp rgb, km", flags=SAVE)
cv_sky_rlh_sh = cvar("sky_rlh_sh", CVarType.Float, 8.5, "rayleigh scale height, km", 0.1, 10.0, SAVE)
cv_sky_mie_mfp = cvar("sky_mie_mfp", CVarType.Float, 48.0, "mie mfp, km", 10.0, 1000.0, SAVE)
cv_sky_mie_sh = cvar("sky_mie_sh", CVarType.Float, 1.2, "mie scale height, km", 0.1, 10.0, SAVE)
cv_sky_mie_g = cvar("sky_mie_g", CVarType.Float, 0.758, "mie anisotropy", -0.99, 0.99, SAVE)

# --- lightmaps ------------------------------------------------------------
cv_lm_upload = cvar("lm_upload", CVarType.Bool, False, "upload lightmaps (display path)")
cv_lm_gen = cvar("lm_gen", CVarType.Bool, False, "progressive lightmap bake on/off")
cv_lm_density = cvar("lm_density", CVarType.Float, 4.0, "lightmap texels per meter", 0.1, 32.0, SAVE)
cv_lm_timeslice = cvar("lm_timeslice", CVarType.Int, 1, "bake 1/N texels per frame", 1, 1024, SAVE)
cv_lm_spp = cvar("lm_spp", CVarType.Int, 1, "lightmap samples per pass", 1, 1024, SAVE)
