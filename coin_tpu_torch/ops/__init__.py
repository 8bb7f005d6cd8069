"""Box algebra, NMS and RoIAlign (counterparts of coin_tpu/ops)."""
