"""Detector modules (counterparts of coin_tpu/models)."""
