"""The system under test for the Moonlight-16B-A3B training cell: the
SeqFormer's own training path over the DeepSeek-V3 blocks.

``TrainState.create`` over the benchmark's weights under Adam(lr),
``make_train_step(seqformer.episode_loss_fn, balance=...)`` in bfloat16
with the flash attention of ``worldmodel.make_attn('flash', T)`` and the
blocks' settings (``arch``) from the configuration: latent attention, the
DeepSeekMoE layers over the held experts with their balancing biases
(``moe.Balance``, stepped inside the captured graph).  On the card the
step is the program's captured CUDA graph (its first two calls are eager
warm-ups, the third captures and replays).  The benchmark's loop keeps
every loss on the device.

The routing biases start at zero in ``moe.Balance``, as DeepSeek-V3's
do; the reference starts from the same.  The held experts' rows live in
one arena of every held assignment the tokens can make, so no routing
drops a row.

The configuration's keys are the published ``config.json``'s.  Where it
also carries the harness's small-size keys (``d_model``, ``n_heads``,
``d_ff``, ``n_layers``, ``max_len``: the benchmark's CPU tests cut every
cell by them), those take the place of ``hidden_size``,
``num_attention_heads``, ``intermediate_size``, ``num_hidden_layers`` and
``max_position_embeddings`` (:func:`resolve`).

The module also makes the weights from the seed (:func:`make_weights`)
and runs the plain reference's first steps (:func:`reference_readings`,
``portbench/reference/mla_moe.py``).

A planted fault (``fault=``) breaks the timed path for the tests of
``correct``: ``frozen`` returns the state unchanged, ``half_batch`` steps
on the first half of each batch.
"""

from __future__ import annotations

import functools

import numpy as np

from portbench.harness import weights_mla
from portbench.reference import mla_moe as ref_model

#: score-matrix cells a head that the reference holds at a time: whole
#: sequences of up to 8,192 steps, one at a time at the cell's size
REF_CELLS = 8192 * 8192


#: the harness's small-size keys and the published keys they stand for
SMALL_KEYS = {"d_model": "hidden_size", "n_heads": "num_attention_heads",
              "d_ff": "intermediate_size", "n_layers": "num_hidden_layers",
              "max_len": "max_position_embeddings"}


def resolve(cfg):
    """The configuration under its published keys, the harness's
    small-size keys (:data:`SMALL_KEYS`) folded in where given."""
    return dict(cfg, **{pub: cfg[small] for small, pub in SMALL_KEYS.items() if small in cfg})


def make_weights(cfg, seed, device):
    """float32 weights on ``device`` from ``seed`` (``harness/weights_mla.py``)."""
    return weights_mla.make(resolve(cfg), seed, device)


def reference_readings(torch, cfg, seed, batches, device, mm=None, rows=None, lr=None):
    """The reference's first steps from the seed's weights, float32, TF32
    off: one per batch of ``batches`` (host arrays).  ``mm``, ``rows`` and
    ``lr`` put a lower precision, half of each batch or a rate of 0 in the
    program's place (the control and the planted faults)."""
    cfg = resolve(cfg)
    params = weights_mla.make(cfg, seed, device)
    eps = [torch.from_numpy(np.asarray(b)).to(device) for b in batches]
    kw = {} if mm is None else {"mm": mm}
    with ref_model.exact_matmuls():
        out = ref_model.train_readings(params, eps, cfg, cfg["lr"] if lr is None else lr,
                                       rows=rows, chunk=ref_rows(eps[0].shape[1] - 1), **kw)
    del params, eps
    return out


def ref_rows(seq_len):
    """Rows of a batch that go through the reference at a time."""
    return max(1, REF_CELLS // (seq_len * seq_len))


def arch(cfg, balance=None):
    """The DeepSeek-V3 blocks' settings for ``seqformer``'s forward."""
    return {"norm_eps": cfg["rms_norm_eps"], "kv_norm_eps": cfg["kv_norm_eps"],
            "rope_theta": cfg["rope_theta"], "moe_k": cfg["num_experts_per_tok"],
            "moe_scale": cfg["routed_scaling_factor"], "moe_experts": cfg["router_experts"],
            "moe_first": cfg["first_held_expert"], "balance_alpha": cfg["balance_alpha"], "balance": balance}


class Program:
    def __init__(self, torch, cfg, traffic, params, device, fault=None):
        from blendjax_torch import worldmodel
        from blendjax_torch.models import moe, seqformer
        from blendjax_torch.models.train import TrainState, make_train_step

        cfg = resolve(cfg)
        if (cfg["compute_dtype"], cfg["attn"]) != ("bfloat16", "flash"):
            raise SystemExit("portbench: the program runs bfloat16 compute through flash attention")
        if traffic["seq_len"] > cfg["max_position_embeddings"]:
            raise SystemExit("portbench: the traffic's seq_len exceeds the configuration's "
                             "positions")
        self.torch = torch
        moe_layers = [f"blocks.{i}" for i in range(cfg["first_k_dense_replace"],
                                                   cfg["num_hidden_layers"])]
        self.balance = moe.Balance(moe_layers, cfg["router_experts"], cfg["n_routed_experts"],
                                   cfg["bias_update_speed"], device)
        self.loss_fn = functools.partial(
            seqformer.episode_loss_fn, compute_dtype=torch.bfloat16,
            attn_fn=worldmodel.make_attn("flash", traffic["seq_len"]),
            arch=arch(cfg, self.balance))
        self.state = TrainState.create(params, lr=cfg["lr"])
        self._step = make_train_step(self.loss_fn, balance=self.balance)
        self.fault = fault
        self.half = traffic["batch"] // 2

    def step(self, batch):
        """One training step; returns the loss, on the device."""
        if self.fault == "frozen":
            with self.torch.no_grad():
                return self.loss_fn(self.state.params, batch).detach()
        if self.fault == "half_batch":
            batch = {"episode": batch["episode"][: self.half]}
        self.state, loss = self._step(self.state, batch)
        return loss

    def first_grads(self):
        """Each leaf's first gradient as Adam holds it after one step (its
        first moment is ``(1 - beta1) * g``), as a host tensor; zeros where
        Adam holds no moment."""
        torch = self.torch
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        out = {}
        for k, p in self.state.params.items():
            m = self.state.optimizer.state.get(p, {}).get("exp_avg")
            out[k] = (m / (1 - beta1)).to("cpu") if m is not None else torch.zeros(p.shape)
        return out

    def change_norms(self, start):
        """Each leaf's change from ``start`` (host tensors), as a norm."""
        torch = self.torch
        out = {}
        with torch.no_grad():
            for k, p in self.state.params.items():
                out[k] = torch.linalg.vector_norm(p - start[k].to(p.device))
        return {k: float(v) for k, v in out.items()}

    def counters(self):
        """The DeepSeekMoE layers' device counters, read to the host
        (``moe.Balance.read``)."""
        return self.balance.read()

    def close(self):
        self.state = self._step = self.loss_fn = None
