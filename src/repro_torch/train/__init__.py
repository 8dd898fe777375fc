"""Training substrate of the port: optimizer, schedules, loop, data,
checkpointing, fault tolerance (single device; DiLoCo and the sharded
steps come with the distributed slice)."""
from .checkpoint import (restore_into, restore_latest, save, save_async,
                         save_replicated, save_replicated_async)
from .data import DataConfig, SyntheticLM, pod_step_grid
from .fault_tolerance import (DetectionPolicy, FaultTolerantTrainer,
                              FTConfig, screen_init, screen_update)
from .loop import (TrainConfig, init_train_state, make_eval_step,
                   make_fused_steps, make_train_step)
from .optimizer import (AdamWConfig, adamw_update, clip_by_global_norm,
                        global_norm, init_opt_state)
from .schedule import get_schedule, warmup_cosine, wsd
