"""The offline, windowed schedule: one ``window_feed`` call per window of
``entry["window"]`` frames (the last may be shorter), ``window_flush`` at
the end of the drive.  A window's poses come back with the next call (or
with the flush); the device scans window N + 1 while the host commits
window N and runs its keyframes' mapping work."""

# System methods (and SlamMap methods, as ``map.<name>``) that a traced
# run wraps in spans: the layers this schedule calls into
SPANS = ("window_feed", "_dispatch_window", "_commit_window", "_retrack_window_frame",
         "_run_maintenance_queue", "window_flush", "map.local_ba")


def feed(system, route, i: int, entry: dict) -> int:
    """Hand in the window of frames from ``i``; returns how many."""
    k = min(entry["window"], len(route.timestamps) - i)
    system.window_feed(route.left[i:i + k], route.right[i:i + k],
                       route.timestamps[i:i + k])
    return k


def finish(system) -> None:
    """The end of the drive: the call that returns the last window's poses."""
    system.window_flush()
