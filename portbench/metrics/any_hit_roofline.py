"""Percent: as closest_hit_roofline, for the any-hit (shadow)
queries and the op tracer_tpu_torch::any_hit."""


def read(run):
    bound = run.trace.get("bound_s", {}).get("any")
    spent = run.trace.get("op_device_s", {}).get("any")
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
