"""Pascal-VOC evaluation and result printing (copies of
coin_tpu/evaluation/voc_eval.py and testing.py)."""
from coin_tpu_torch.evaluation.voc_eval import (VOCEvaluator, voc_ap,
                                                voc_eval_class)  # noqa: F401
from coin_tpu_torch.evaluation.testing import (print_csv_format,
                                               verify_results)  # noqa: F401
