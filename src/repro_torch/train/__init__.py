"""Training substrate of the port: optimizer, schedules, loop, data,
checkpointing, fault tolerance, DiLoCo rounds and their supervisor, and
the publisher of verified params to a co-resident serving engine (one
device; the sharded steps and the hop over a pod group of cards wait for
ROADMAP A3b)."""
from .checkpoint import (restore_into, restore_latest, save, save_async,
                         save_replicated, save_replicated_async)
from .data import DataConfig, SyntheticLM, pod_step_grid
from .diloco import (DiLoCoConfig, diloco_init, isl_bytes_per_step,
                     make_diloco_round, make_inner_steps, outer_step,
                     outer_wire_bytes, snapshot_global_params)
from .fault_tolerance import (DetectionPolicy, DiLoCoSupervisor,
                              FaultTolerantTrainer, FTConfig, screen_init,
                              screen_update)
from .loop import (TrainConfig, init_train_state, make_eval_step,
                   make_fused_steps, make_train_step, train_state_from_jax)
from .optimizer import (AdamWConfig, adamw_update, clip_by_global_norm,
                        global_norm, init_opt_state)
from .publish import ParamPublisher, PublishConfig
from .schedule import get_schedule, warmup_cosine, wsd
