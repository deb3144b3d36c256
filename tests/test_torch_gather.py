"""Gathering a sharded DTensor whole through c10d's all-gather
(``blendjax_torch.parallel.sharding.gather_whole``), the route a
tensor-parallel state's checkpoint takes on the card, where DTensor's own
``full_tensor()`` (the functional all-gather) crashes torch 2.11's gloo.

On 2 real gloo ranks (``helpers/torch_ranks.py``) a ``{"model": 2}``
state whose sharded dimensions do not split evenly (7 features: shards of
4 and 3) takes one Adam step; its parameters and Adam moments from
``convert.train_state_arrays`` equal, bit for bit, the same state's
``full_tensor()`` path on the CPU, on both ranks.
"""

import numpy as np
import pytest

from helpers import torch_parallel_ranks
from helpers.time_limit import time_limit
from helpers.torch_ranks import Ranks


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(torch_parallel_ranks.gather_cases, 2)
    try:
        yield r
    finally:
        r.close()


@time_limit(120)
def test_uneven_tp_state_gathers_bit_equal_to_full_tensor(ranks):
    out = ranks.result("gather", 110)
    for rec in out.values():
        assert rec["placements"]["fc.w"] == ["Shard(dim=1)"]
        assert rec["placements"]["head.w"] == ["Shard(dim=0)"]
        assert rec["count"] == 1 and rec["step"] == 1
        assert len(rec["helper"]) == len(rec["full_tensor"]) == 3 * len(rec["names"])
        for got, want in zip(rec["helper"], rec["full_tensor"]):
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        for i, name in enumerate(rec["names"]):
            np.testing.assert_array_equal(rec["whole"][name], rec["full_tensor"][i])
    # the shards really were uneven: 4 and 3 of the 7 features
    assert sorted(out[r]["local_shapes"]["fc.w"] for r in out) == [(5, 3), (5, 4)]
    for a, b in zip(out[0]["helper"], out[1]["helper"]):
        np.testing.assert_array_equal(a, b)
