"""Inference engines."""
