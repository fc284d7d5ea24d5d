"""Percent: the least time the card could take over the closest-hit
queries of a call (yardstick/roofline.py, on the tapped call's rays)
over the device time of the op tracer_tpu_torch::closest_hit in the
profiled call of the same work. Offline entries, traced runs."""


def read(run):
    bound = run.trace.get("bound_s", {}).get("closest")
    spent = run.trace.get("op_device_s", {}).get("closest")
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
