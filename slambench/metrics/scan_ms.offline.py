"""Host time to enqueue a window's scan in the offline schedule
(``System._dispatch_window`` and ``tracking.fused_track_window``: the
window's one upload and the device program of its frames):
``System.times["window.dispatch"]`` over the window's untraced calls, per
frame handed in.  No stage clock runs inside it, so nothing is
subtracted."""


def read(record):
    t = record["times"].get("window.dispatch")
    if not t or not record["times_frames"]:
        return None
    return 1e3 * t / record["times_frames"]
