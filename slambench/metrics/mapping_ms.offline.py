"""Host time of the keyframe side in the offline schedule: keyframe
insertion (with its snapshot read, and the mapping it runs at once where
nothing defers it: the first frames and the end-of-drive flush) and the
mapping work ``window_feed`` runs behind the scan (the staged
triangulation / fuse and local BA, the loop stage and global-BA slices):
``System.times["keyframe_side"]``, the ``kf.*`` stage clocks with each
stretch counted once however they nest, over the window's untraced calls,
per frame handed in.  Keyframe culling (``kf.cull``, a span and no stage
clock) is not in it.  None where the program keeps no
``"keyframe_side"``."""


def read(record):
    t = record["times"].get("keyframe_side")
    if t is None or not record["times_frames"]:
        return None
    return 1e3 * t / record["times_frames"]
