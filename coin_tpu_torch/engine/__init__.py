"""Inference pipelines and the evaluation loop (counterparts of
coin_tpu/engine)."""
