"""Host time of the windowed commit's re-tracks
(``System._retrack_window_frame``: a scanned frame tracked again on the
device against the current map, at 7 px and, where that is weak, at
28 px, each attempt read back at once): ``System.times["window.retrack"]``
over the window's untraced calls, per frame handed in; 0 where commits ran
and none re-tracked.  No stage clock runs inside it."""


def read(record):
    times = record["times"]
    if "window.commit_total" not in times or not record["times_frames"]:
        return None
    return 1e3 * times.get("window.retrack", 0.0) / record["times_frames"]
