"""The twins of ``tests/test_multihost.py`` on the port: 2 real gloo ranks
(``helpers/torch_ranks.py``) in place of 2 ``jax.distributed`` processes.

- Each rank feeds its ``shard=(rank, 2)`` of one producer fleet through
  ``TorchStream(sharding=data_sharding(mesh))``: the global batch is
  assembled from the ranks' local halves (``put_batch``'s
  ``DTensor.from_local`` branch), the shards are disjoint and cover 16
  items, and a reduction over the global batch agrees across ranks.
- A 2-rank sharded train step on different local data per rank: equal
  losses and parameters on both ranks (the gradient all-reduce crossed
  the process boundary), equal within 1e-5 to the port's single-process
  step on the concatenated batches; a checkpoint saved by rank 0 restores
  equal (parameters and Adam's moments, bit for bit) on both.
"""

import numpy as np
import torch

from blendjax_torch.models.train import TrainState, make_train_step
from helpers import producers, torch_parallel_ranks
from helpers.time_limit import time_limit
from helpers.torch_ranks import Ranks


def _run(program, args, case, timeout):
    ranks = Ranks(program, 2, args)
    try:
        return ranks.result(case, timeout)
    finally:
        ranks.close()


@time_limit(150)
def test_two_rank_global_batch_assembly():
    fleet = producers.ProducerFleet(num_producers=1, shape=(8, 8, 3))
    fleet.start()
    try:
        out = _run(torch_parallel_ranks.multihost_feed, {"addresses": fleet.addresses},
                   "feed", 140)
    finally:
        fleet.close()
    for o in out.values():
        assert o["batches"] == 1
        # global batch = 2 ranks x 8 local items, each rank holding its half
        assert o["global_shape"] == (16, 8, 8, 3)
        assert o["local_shape"] == (8, 8, 8, 3)
        # max_items consistency: 16 // (1 worker * 2 shards) = 8 items each
        assert len(o["frameids"]) == 8
    ids0, ids1 = set(out[0]["frameids"]), set(out[1]["frameids"])
    assert not ids0 & ids1
    assert len(ids0 | ids1) == 16
    assert out[0]["mean"] == out[1]["mean"]


def _train_inputs():
    rng = np.random.default_rng(0)  # identical params on every rank
    params = {"w1": rng.standard_normal((6, 16)).astype(np.float32),
              "w2": rng.standard_normal((16, 3)).astype(np.float32)}
    batches = []
    for i in range(3):
        per_rank = []
        for rank in range(2):
            prng = np.random.default_rng(100 + 10 * i + rank)
            per_rank.append({"x": prng.standard_normal((2, 6)).astype(np.float32),
                             "y": prng.standard_normal((2, 3)).astype(np.float32)})
        batches.append(per_rank)
    return params, batches


@time_limit(150)
def test_two_rank_sharded_train_and_checkpoint(tmp_path):
    params, batches = _train_inputs()
    out = _run(torch_parallel_ranks.multihost_train,
               {"params": params, "batches": batches, "dir": str(tmp_path)}, "train", 140)
    assert out[0]["losses"] == out[1]["losses"]
    for k in params:
        np.testing.assert_array_equal(out[0]["params"][k], out[1]["params"][k])
    assert out[0]["losses"][-1] < out[0]["losses"][0]
    for o in out.values():
        assert o["restored_equal"] and o["adam_equal"]
        assert o["restored_step"] == 3

    def loss_fn(p, batch):
        pred = torch.tanh(batch["x"] @ p["w1"]) @ p["w2"]
        return torch.mean((pred - batch["y"]) ** 2)

    state = TrainState.create({k: torch.from_numpy(v) for k, v in params.items()}, lr=1e-2)
    step = make_train_step(loss_fn)
    losses = []
    for per_rank in batches:
        whole = {k: torch.from_numpy(np.concatenate([b[k] for b in per_rank])) for k in ("x", "y")}
        state, loss = step(state, whole)
        losses.append(float(loss))
    np.testing.assert_allclose(out[0]["losses"], losses, atol=1e-5, rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(out[0]["params"][k], state.params[k].detach().numpy(),
                                   atol=1e-5)

