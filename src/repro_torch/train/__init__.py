"""Training substrate: optimizer, loss, step factory, checkpointing."""

from .optimizer import (AdamState, AdamWConfig, MeshLayout, adamw_init,
                        adamw_update, cosine_schedule, get_schedule,
                        wsd_schedule)
from .loss import next_token_loss
from .train_step import (TrainState, checkpoint_layout, init_train_state,
                         make_loss_fn, make_train_step)
from .checkpoint import Checkpointer
