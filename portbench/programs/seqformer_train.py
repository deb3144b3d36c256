"""The system under test for the SeqFormer training cells: the program's
own entry, as ``blendjax_torch.worldmodel.train_on_episodes`` builds it.

``TrainState.create`` over the benchmark's weights under Adam(lr),
``make_train_step(seqformer.episode_loss_fn)`` in bfloat16 with the flash
attention of ``worldmodel.make_attn('flash', T)``.  On the card the step
is the program's captured CUDA graph (its first two calls are eager
warm-ups, the third captures and replays).  The
benchmark's loop keeps every loss on the device.

The module also makes the weights from the seed (:func:`make_weights`)
and runs the plain reference's first steps (:func:`reference_readings`).

A planted fault (``fault=``) breaks the timed path for the tests of
``correct``: ``frozen`` returns the state unchanged, ``half_batch`` steps
on the first half of each batch.
"""

from __future__ import annotations

import functools

import numpy as np

from portbench.harness import weights
from portbench.reference import seqformer as ref_model

#: score-matrix cells a head that the reference holds at a time: 16 rows
#: at T 512, one at T 2048 and more, so that its float32 activations and
#: full score matrices fit on the card
REF_CELLS = 16 * 512 * 512


def make_weights(cfg, seed, device):
    """float32 weights on ``device`` from ``seed`` (``harness/weights.py``)."""
    return weights.make(cfg, seed, device)


def reference_readings(torch, cfg, seed, batches, device, mm=None, rows=None, lr=None):
    """The reference's first steps from the seed's weights, float32, TF32
    off: one per batch of ``batches`` (host arrays).  ``mm``, ``rows`` and
    ``lr`` put a lower precision, half of each batch or a rate of 0 in the
    program's place (the control and the planted faults)."""
    params = weights.make(cfg, seed, device)
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


class Program:
    def __init__(self, torch, cfg, traffic, params, device, fault=None):
        from blendjax_torch import worldmodel
        from blendjax_torch.models import seqformer
        from blendjax_torch.models.train import TrainState, make_train_step

        if (cfg["compute_dtype"], cfg["attn"]) != ("bfloat16", "flash"):
            raise SystemExit("portbench: the program runs bfloat16 compute through flash attention")
        if traffic["seq_len"] > cfg["max_len"]:
            raise SystemExit("portbench: the traffic's seq_len exceeds the position table")
        self.torch = torch
        self.loss_fn = functools.partial(seqformer.episode_loss_fn, compute_dtype=torch.bfloat16,
                                         attn_fn=worldmodel.make_attn("flash", traffic["seq_len"]))
        self.state = TrainState.create(params, lr=cfg["lr"])
        self._step = make_train_step(self.loss_fn)
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

    def close(self):
        self.state = self._step = self.loss_fn = None
