"""Self-training (stage 2 of the paper): train, relabel, retrain
(counterpart of ``spalign_tpu/selftrain``)."""

from spalign_tpu_torch.selftrain.relabel import (NpzShardWriter,
                                                 relabel_dataset)
from spalign_tpu_torch.selftrain.rounds import RoundsDriver

__all__ = ["NpzShardWriter", "RoundsDriver", "relabel_dataset"]
