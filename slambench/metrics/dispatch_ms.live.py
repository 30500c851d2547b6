"""Host time to enqueue a frame's tracking program in the pipelined
schedule: ``System.times["async.dispatch"]`` over the window's untraced
calls, per frame handed in."""


def read(record):
    t = record["times"].get("async.dispatch")
    if not t or not record["times_frames"]:
        return None
    return 1e3 * t / record["times_frames"]
