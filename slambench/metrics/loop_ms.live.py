"""Host time of the loop stage in the pipelined schedule: the loop closer
on each keyframe (BoW detection, the Sim3 solve, the correction of the
essential graph and loop fusion) and the global-BA slices run after it,
``System.times["kf.loop"] + System.times["kf.gba_slice"]`` over the
window's untraced calls, per frame handed in.  With the traffic's
``trace_session`` 1 those calls hold the first session whole, its
closure included.  None where neither clock ran."""

STAGES = ("kf.loop", "kf.gba_slice")


def read(record):
    times = record["times"]
    if not any(k in times for k in STAGES) or not record["times_frames"]:
        return None
    return 1e3 * sum(times.get(k, 0.0) for k in STAGES) / record["times_frames"]
