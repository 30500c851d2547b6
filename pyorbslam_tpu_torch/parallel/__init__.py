"""Multi-device engines: sharded global BA, the sharded essential graph
and the multi-process runtime (port of ``pyorbslam_tpu/parallel``)."""
