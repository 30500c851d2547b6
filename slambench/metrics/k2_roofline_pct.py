"""K2, the steered rBRIEF kernel on the blurred canvas
(``csrc/brief_canvas.cu``): its least time on the card
(``bounds.brief_bound_s`` at the launch's keypoint slots, both images)
over its mean device time per launch in the traced stretch, in %."""

import bounds

KERNEL = "brief_canvas_kernel"


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
    slots = 2 * bounds.features_per_level_sum(orb.n_features, orb.scale_factor,
                                              orb.n_levels)
    return 100.0 * bounds.brief_bound_s(slots, rows * cols) / (seconds / count)
