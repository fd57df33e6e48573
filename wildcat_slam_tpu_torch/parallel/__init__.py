"""Batched windows over CUDA devices (counterpart of ``wildcat_slam_tpu/parallel``)."""
