"""Dataset readers, synthetic data generation, and trajectory export
(counterpart of ``wildcat_slam_tpu/io``; numpy only)."""
