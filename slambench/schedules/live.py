"""The live, pipelined per-frame schedule: one ``track_stereo_async`` call
a frame, ``flush_async`` at the end of the drive.  A frame's pose comes
back with the next call (or with the flush)."""

# System methods (and SlamMap methods, as ``map.<name>``) that a traced
# run wraps in spans: the layers this schedule calls into
SPANS = ("track_stereo_async", "_dispatch_chain", "_commit_chain",
         "_run_maintenance_queue", "_track", "flush_async", "map.local_ba")


def feed(system, route, i: int, entry: dict) -> int:
    """Hand in frame ``i``; returns the number of frames handed in."""
    system.track_stereo_async(route.left[i], route.right[i], route.timestamps[i])
    return 1


def finish(system) -> None:
    """The end of the drive: the call that returns the last poses."""
    system.flush_async()
