"""Seeded stereo scenes with ground truth, one module a scene."""
