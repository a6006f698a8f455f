"""shading_ms_per_step.<kind>: device ms a step of the work whose launch
stack passes through the shading, NEE, sky and exposure modules
(`trace.LAYERS`' "shading" group) and through no intersection or gather
wrapper."""


def read(t, kind):
    if t.steps <= 0:
        return None
    s = t.group_seconds("shading")
    return s * 1e3 / t.steps if s > 0 else None
