"""The port's runnable examples (counterparts of the repository's
``examples/quickstart.py`` and ``examples/explore.py``):

  python -m spalign_tpu_torch.examples.quickstart [--device cpu]
  python -m spalign_tpu_torch.examples.explore [--device cpu]

Each runs on the card by default (``--device cuda``) and takes size
flags, so that it can run small."""
