"""Faults planted in the data-parallel train step, in every rank's
process (the other ranks call the function named by ``--hook``)."""


def skip_exchange():
    """The gradient all-reduce left out: each rank steps on its own rows'
    gradients, the loss its own rows' share."""
    from spalign_tpu_torch.train.trainer import Trainer

    Trainer._average = lambda self, grads, loss: loss
