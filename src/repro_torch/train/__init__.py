"""Training of the port: the train step (forward, backward through the
kernels' plain versions, grad sync, clip, AdamW) and the loop with
checkpoints and exact resume (the mirror of :mod:`repro.train`)."""
from .step import (ShardedState, TrainState, loss_and_grads,
                   make_train_step, state_from_tree, state_tree,
                   train_state_init)

__all__ = ["ShardedState", "TrainState", "loss_and_grads",
           "make_train_step", "state_from_tree", "state_tree",
           "train_state_init"]
