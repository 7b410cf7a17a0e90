"""Frames: loading (packed `.npy` or image files), the test-time
transforms, and the host-to-card convention."""
