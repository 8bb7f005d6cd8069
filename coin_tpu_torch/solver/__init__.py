from coin_tpu_torch.solver.build import (ScheduledSGD, build_optimizer,
                                         lr_multiplier_for_path,
                                         make_schedule,
                                         two_stage_lr_schedule)
