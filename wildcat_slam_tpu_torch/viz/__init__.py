"""Map exports for external viewers (counterpart of ``wildcat_slam_tpu/viz``; numpy only)."""
