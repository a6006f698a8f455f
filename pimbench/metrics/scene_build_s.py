"""scene_build_s: host seconds to build the configuration's scene (and a
bake's lightmap pack), synchronised, within set-up."""


def read(t, kind):
    v = t.extra.get("scene_build_s")
    return float(v) if v else None
