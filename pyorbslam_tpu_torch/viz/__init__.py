"""The live viewer and the offline drawer (port of ``pyorbslam_tpu/viz``)."""
