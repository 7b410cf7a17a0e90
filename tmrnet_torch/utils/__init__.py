"""Checkpoints and metric logging of the trainers."""
