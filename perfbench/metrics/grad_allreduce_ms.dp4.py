"""Several ranks: device milliseconds of a step's gradient all-reduce
(the ``train.grad_allreduce`` device span around ``Trainer._average``),
mean over rank 0's traced steps.  The rest of ``nccl_pct.dp4`` is the
batch norms' statistics."""

from perfbench import spans


def read(run):
    v = spans.mean(s.device_ns for s in spans.traced()
                   if s.name == "train.grad_allreduce"
                   and s.device_ns is not None)
    return None if v is None else v / 1e6
