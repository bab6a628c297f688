"""The training step (the JAX package's ``repro.train``), one device."""
from .step import (TRAIN_FAMILIES, TrainHyper, cross_entropy_loss,
                   init_optimizer, loss_and_grads, make_train_step,
                   microbatches_for)

__all__ = ["TRAIN_FAMILIES", "TrainHyper", "cross_entropy_loss",
           "init_optimizer", "loss_and_grads", "make_train_step",
           "microbatches_for"]
