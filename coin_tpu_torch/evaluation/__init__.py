"""Pascal-VOC evaluation (copy of coin_tpu/evaluation/voc_eval.py)."""
from coin_tpu_torch.evaluation.voc_eval import (VOCEvaluator, voc_ap,
                                                voc_eval_class)  # noqa: F401
