"""Share of the untraced pace in which no operation ran on the device, in
%: 1 - (device busy seconds a frame, the union of the operation intervals
of the device-only traced stretch) / (wall seconds a frame of the same
session's untraced frames 8-39).  Tracing slows the host's launches, not
the device's work, so the traced stretch's own window would read the
profiler's overhead as idle."""


def read(record):
    tr = record["trace"]
    if not tr or tr["busy_s"] <= 0 or not tr["frames"] or not tr["pace_ms"]["untraced"]:
        return None
    return 100.0 * (1.0 - (tr["busy_s"] / tr["frames"]) / (tr["pace_ms"]["untraced"] * 1e-3))
