"""Data-parallel training of the port (parallel/dist.py, the global-batch
BatchNorm of models/segnet.py, train/losses.rank_loss_fn, the Trainer's
gradient all-reduce, the Evaluator's reduced confusion, the loader's
rank slices) on 2 gloo CPU ranks, spawned with torch.multiprocessing
and a file:// rendezvous, against one rank and against the JAX
package's one-device step.

Tolerances: a 2-rank MomentumSGD step against the 1-rank step on the
same global batch: loss and gradient norm rtol 1e-5; parameters and BN
running statistics rtol 1e-4 / atol 1e-5 (the bar of
tests/test_train.py::TestTrainStep::test_data_parallel_equals_single_device);
the ranks' states equal each other exactly.  Against JAX's make_train_step
from the same converted weights: the gate of
tests/test_torch_train.py::test_momentum_sgd_step_matches_jax (loss and
gradient norm rtol 1e-5, parameters and statistics rtol 1e-4 / atol
1e-5).  The evaluator's confusion counts equal one rank's exactly, its
loss within rtol 1e-6.  A one-rank process group is bit-equal to no
group."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from spalign_tpu.config import TrainConfig as JaxTrainConfig
from spalign_tpu.train import create_train_state, make_train_step
from spalign_tpu_torch.config import TrainConfig
from spalign_tpu_torch.convert.from_jax import segnet_state_dict_from_flax
from spalign_tpu_torch.data.loader import PrefetchLoader
from spalign_tpu_torch.parallel import rank_slice
from spalign_tpu_torch.train.evaluator import Evaluator
from spalign_tpu_torch.train.losses import get_loss_fn
from spalign_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
HW = (32, 64)
B, WORLD = 8, 2
LOSSES = ("ce", "soft", "mse")
VOID = {0: 0.6, 1: 0.05}  # void share of each rank's rows for 'ce'


def _kw(loss):
    return dict(model="basic", batchsize=B, input_shape=HW, eval_shape=HW,
                optimizer="MomentumSGD", lr=0.1, weight_decay=5e-4,
                loss=loss)


def _batch(loss, rng):
    """A global batch whose left half is class 0 and right half class 1;
    'ce' voids 60% of rank 0's pixels and 5% of rank 1's, 'soft' and
    'mse' take noisy class scores."""
    labels = np.zeros((B, *HW), np.int32)
    labels[:, :, HW[1] // 2:] = 1
    imgs = (np.where(labels[..., None] == 1, 1.0, -1.0)
            + rng.randn(B, *HW, 3) * 0.5).astype(np.float32)
    if loss == "ce":
        for r, share in VOID.items():
            rows = rank_slice(labels, r, WORLD)
            rows[rng.rand(*rows.shape) < share] = -1
        return imgs, labels
    onehot = np.stack([labels == 0, labels == 1], -1).astype(np.float32)
    soft = onehot + rng.rand(B, *HW, 2).astype(np.float32) * 0.3
    return imgs, soft / soft.sum(-1, keepdims=True)


def _val_batches(rng):
    """Eval batches of 4, 4 and a ragged tail of 3 images, with voids."""
    out = []
    for n in (4, 4, 3):
        imgs = rng.randn(n, *HW, 3).astype(np.float32)
        out.append((imgs, rng.randint(-1, 2, (n, *HW)).astype(np.int32)))
    return out


def _rank_main(rank, tmp):
    """One rank: a step per loss from the shared initial weights on its
    rows of the global batch, then the evaluator; results to a file."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=WORLD)
    try:
        inputs = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        out = {}
        for loss in LOSSES:
            tr = Trainer(TrainConfig(**_kw(loss),
                                     result_dir=f"{tmp}/{loss}"),
                         device="cpu")
            assert (tr.world, tr.rank) == (WORLD, rank)
            tr.model.load_state_dict(inputs["init"])
            imgs, labels = inputs[loss]
            m = tr.train_step(*tr.to_device(rank_slice(imgs, rank, WORLD),
                                            rank_slice(labels, rank,
                                                       WORLD)))
            out[loss] = {"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "state": tr.model.state_dict()}
        out["eval"] = Evaluator(tr.model, lambda: iter(inputs["val"]), HW,
                                device="cpu")()
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, [rank 0's results, rank 1's], the 1-rank results)."""
    tmp = tmp_path_factory.mktemp("ddp")
    rng = np.random.RandomState(0)
    jcfg = JaxTrainConfig(**_kw("ce"), seed=0)
    state = create_train_state(jcfg, sample_batch_shape=HW)
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    inputs = {"init": segnet_state_dict_from_flax(variables, "basic"),
              "variables": variables, "val": _val_batches(rng)}
    for loss in LOSSES:
        inputs[loss] = _batch(loss, rng)
    torch.save(inputs, tmp / "inputs.pt")
    ctx = mp.start_processes(_rank_main, args=(str(tmp),), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.time() + 300
    while not ctx.join(timeout=5):  # raises if a rank failed
        if time.time() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("the ranks did not finish within 300 s")
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    one = {}
    for loss in LOSSES:
        tr = Trainer(TrainConfig(**_kw(loss), result_dir=str(tmp / "one")),
                     device="cpu")
        tr.model.load_state_dict(inputs["init"])
        m = tr.train_step(*tr.to_device(*inputs[loss]))
        one[loss] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "state": tr.model.state_dict()}
    one["eval"] = Evaluator(tr.model, lambda: iter(inputs["val"]), HW,
                            device="cpu")()
    return inputs, ranks, one


def _assert_states_close(got, want):
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("loss", LOSSES)
def test_two_ranks_equal_one_rank(runs, loss):
    _, ranks, one = runs
    for k, v in ranks[0][loss]["state"].items():
        assert torch.equal(v, ranks[1][loss]["state"][k]), k
    got, want = ranks[0][loss], one[loss]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-5)
    _assert_states_close(got["state"], want["state"])


def test_uneven_voids_split_the_per_rank_mean(runs):
    """The 'ce' batch is the case a per-rank mean gets wrong: on any
    logits, the mean of the ranks' own means is another loss than the
    global mean, by far more than the tolerance above."""
    inputs, _, _ = runs
    _, labels = inputs["ce"]
    labels = torch.from_numpy(labels)
    logits = torch.from_numpy(
        np.random.RandomState(1).randn(B, *HW, 2).astype(np.float32))
    ce = get_loss_fn("ce")
    per_rank = np.mean([float(ce(rank_slice(logits, r, WORLD),
                                 rank_slice(labels, r, WORLD)))
                        for r in range(WORLD)])
    assert abs(per_rank - float(ce(logits, labels))) > 1e-3


@pytest.mark.parametrize("loss", LOSSES)
def test_two_ranks_match_jax_one_device(runs, loss):
    inputs, ranks, _ = runs
    jcfg = JaxTrainConfig(**_kw(loss), seed=0)
    state = create_train_state(jcfg, sample_batch_shape=HW)
    state = state.replace(params=inputs["variables"]["params"],
                          batch_stats=inputs["variables"]["batch_stats"])
    imgs, labels = inputs[loss]
    new, m = make_train_step(jcfg)(state, jnp.asarray(imgs),
                                   jnp.asarray(labels))
    got = ranks[0][loss]
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]),
                               rtol=1e-5)
    _assert_states_close(got["state"], segnet_state_dict_from_flax(
        jax.device_get({"params": new.params,
                        "batch_stats": new.batch_stats}), "basic"))


def test_evaluator_two_ranks_equal_one_rank(runs):
    """Each rank predicts its rows of the eval batches; the ragged tail
    of 3 runs on rank 0 alone; the reduced confusion is one rank's."""
    _, ranks, one = runs
    for r in ranks:
        assert set(r["eval"]) == set(one["eval"])
        for k, v in one["eval"].items():
            if k == "main/loss":
                np.testing.assert_allclose(r["eval"][k], v, rtol=1e-6)
            else:
                assert r["eval"][k] == v, k


def test_one_rank_group_is_bit_equal(tmp_path):
    """Under a one-rank process group nothing is reduced: two steps equal
    the steps without a group bit for bit."""
    imgs, labels = _batch("ce", np.random.RandomState(5))

    def steps():
        tr = Trainer(TrainConfig(**_kw("ce"), result_dir=str(tmp_path)),
                     device="cpu")
        losses = [float(tr.train_step(*tr.to_device(imgs, labels))["loss"])
                  for _ in range(2)]
        return losses, tr.model.state_dict()

    want_losses, want = steps()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        got_losses, got = steps()
    finally:
        dist.destroy_process_group()
    assert got_losses == want_losses
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_rank_slice_rows_and_message():
    batch = np.arange(8)
    assert [rank_slice(batch, r, 4).tolist() for r in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="not divisible by the 3-device"):
        rank_slice(batch, 0, 3)


def test_loader_ranks_partition_the_global_batches():
    """Every rank draws the same global order from the seed and keeps its
    own rows: the ranks' batches side by side are the 1-rank batches."""
    class Items:
        def __len__(self):
            return 14

        def __getitem__(self, i):
            return np.full((2,), i, np.float32), np.int32(i)

    def batches(**kw):
        return [b[1].tolist() for b in PrefetchLoader(
            Items(), 4, shuffle=True, num_workers=2, epochs=2, seed=3,
            **kw)]

    one = batches()
    per_rank = [batches(rank=r, world=2) for r in range(2)]
    assert len(one) == 6
    assert [a + b for a, b in zip(*per_rank)] == one
