"""Host time of the windowed commit itself (``System._commit_window``:
the window's one read, then each row's bookkeeping, keyframe decision and
landmark creation; rows handed to the per-frame machine count here):
``System.times["window.commit_total"]`` less what is nested in it and
read by the other metrics: the re-tracks (``"window.retrack"``,
``retrack_ms.offline``) and the keyframe stages (``"window.commit_kf"``,
the keyframe side's time inside the commits, ``mapping_ms.offline``),
over the window's untraced calls, per frame handed in.  None where the
program keeps no ``"window.commit_kf"``."""

NESTED = ("window.retrack", "window.commit_kf")


def read(record):
    times = record["times"]
    t = times.get("window.commit_total")
    if not t or "window.commit_kf" not in times or not record["times_frames"]:
        return None
    return 1e3 * (t - sum(times.get(k, 0.0) for k in NESTED)) / record["times_frames"]
