"""Hand-written Hopper kernels (``csrc/``), their plain torch versions and
the device dispatcher (``ops``)."""
