"""Host time of the keyframe side in the pipelined schedule (insertion,
the staged triangulation / fuse and local BA, keyframe culling, the loop
stage and global-BA slices): the ``System.times["kf.*"]`` stages over the
window's untraced calls, per frame handed in.  ``kf.snapshot_read`` runs
inside ``kf.insert_total`` and is left out; on the synchronous fall-back
frames (bootstrap, rescue) the mapping stages also nest inside
``kf.insert_total``."""

NESTED = ("kf.snapshot_read",)


def read(record):
    t = sum(v for k, v in record["times"].items()
            if k.startswith("kf.") and k not in NESTED)
    if not t or not record["times_frames"]:
        return None
    return 1e3 * t / record["times_frames"]
