"""Sliding-window continuous-time lidar-inertial odometry core (PyTorch)."""
