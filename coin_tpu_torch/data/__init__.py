"""VOC indexing, the test loader and input normalisation (counterparts of
coin_tpu/data)."""
