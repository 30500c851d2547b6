"""Kernels launched on the device per frame handed in, over the traced
stretch (the profiler's kernel records; copies and fills not counted)."""


def read(record):
    tr = record["trace"]
    if not tr or not tr["frames"] or not tr["launches"]:
        return None
    return tr["launches"] / tr["frames"]
