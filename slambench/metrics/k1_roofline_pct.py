"""K1, the FAST score kernel (``csrc/fast_score.cu``) on the stereo
pair's atlas canvas: its least time on the card (``bounds.fast_bound_s``)
over its mean device time per launch in the traced stretch, in %."""

import bounds

KERNEL = "fast_score_kernel"


def read(record):
    tr = record["trace"]
    if not tr:
        return None
    runs = [v for n, v in tr["kernels"].items() if KERNEL in n]
    count, seconds = sum(v[0] for v in runs), sum(v[1] for v in runs)
    if not count or seconds <= 0:
        return None
    orb, cam = record["cfg"].orb, record["cfg"].camera
    rows, cols = bounds.canvas_shape(cam.height, cam.width, orb.scale_factor,
                                     orb.n_levels, orb.cell_size)
    return 100.0 * bounds.fast_bound_s(rows * cols) / (seconds / count)
