"""wildcat_slam_tpu_torch -- the PyTorch + CUDA port of wildcat_slam_tpu.

Mirrors the JAX package's layout, one module per counterpart:

- ``ops``      -- Lie-group math, splines, compensated prefix sums, 3x3 eigh,
                  voxel keys, and the two hand-written CUDA kernels with their
                  plain PyTorch versions: ``ops/pcg.py`` (K1, block-Jacobi PCG,
                  ``csrc/pcg.cu``) and ``ops/knn.py`` (K2, per-bin KNN search,
                  ``csrc/knn_bins.cu``). Kernels build with nvcc at first use
                  into ``wildcat_slam_tpu_torch/_build/``.
- ``odometry`` -- states, IMU propagation, window management, surfel
                  extraction, matching, factors, the LM solver and the
                  host-facing ``LidarOdometry`` pipeline.
- ``parallel`` -- batched windows in lockstep over the CUDA cards.
- ``io``       -- synthetic sequences, dataset replay, ROS bags, framed
                  streams, TUM trajectories.
- ``viz``      -- surfel and point-cloud PLY exports.
- ``utils``    -- residual histograms, stage timers and torch.profiler traces.
- ``config``   -- ``WildcatConfig``, the same fields and defaults as the JAX
                  package's.
- ``cli``      -- the command-line entry point.

The port imports torch and never jax, nor anything of the JAX package.
"""

from wildcat_slam_tpu_torch.config import WildcatConfig

__all__ = ["WildcatConfig"]
