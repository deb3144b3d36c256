"""Post-training int8 quantization (w8a8) for inference: the port of
``blendjax.ops.quant``.

- **weights**: per-output-channel symmetric int8, ``round(w / s)`` with
  ``s = amax / 127`` (division, round half to even, clipped to +-127) —
  bit-equal to the JAX package's quantizers on the same weights;
- **activations**: dynamic symmetric int8, one scale per example (or, in
  :func:`maybe_quantized_einsum`, per output-surviving coordinate),
  computed from the live tensor before each product;
- **accumulation**: int32, exact, then dequantized by ``act_scale *
  weight_scale`` to f32 before bias and nonlinearity.

Parameters are the port's flat ``{path: tensor}`` dicts: a quantized
layer's ``{path}.w`` becomes ``{path}.w_q`` (int8) and ``{path}.w_scale``
(f32), its bias stays f32.  Conv kernels are OIHW (the port's layout), so
their scale reduces over (1, 2, 3), one per output channel.

PyTorch's int8 ``einsum``/``matmul`` return int8 and wrap, so every int8
product here goes through :func:`int8_matmul`: ``torch._int_mm`` (int8 x
int8 -> int32; cuBLASLt on the card), its operands zero-padded to the
card's shape limits (exact).  The convs are im2col (strided views of the
SAME-padded input, in the kernel's (kh, kw, c_in) order) followed by the
same product.  These are the library's products, as the JAX package
computes its int8 products in XLA outside any Pallas kernel.

The weight quantizers store ``w_q`` with its contracted axes fastest in
memory (:func:`_weight_layout`; a conv kernel channels-last): the same
shape and values, but the column-major operand ``torch._int_mm`` runs 4.7-
8.9x faster on the card than a row-major one at the flagship's decode
shapes (``probes/int8_mm.py``; PERF.md §6).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from blendjax_torch.models.layers import same_padding

#: ``torch._int_mm`` on CUDA takes m > 16 rows and k, n multiples of 8; the
#: operands are zero-padded to these multiples (zeros add nothing)
_MM_ROWS = 32
_MM_ALIGN = 16


def _round_up(n, m):
    return -(-n // m) * m


def _column_major(b):
    return b.stride(0) == 1 and b.stride(1) == b.shape[0]


def int8_matmul(a, b):
    """(m, k) int8 x (k, n) int8 -> (m, n) int32, exact.  ``b`` is
    column-major, as the quantizers store it (:func:`_weight_layout`); on
    the card the operands are zero-padded to ``torch._int_mm``'s shape
    limits first, ``b`` keeping its layout."""
    m, k = a.shape
    n = b.shape[1]
    if not _column_major(b):
        raise ValueError(
            f"int8_matmul takes a column-major (k, n) weight (strides {b.stride()}); "
            "store it as the quantizers do (_weight_layout)"
        )
    if a.is_cuda:
        mp = max(_MM_ROWS, _round_up(m, _MM_ALIGN))
        kp, np_ = _round_up(k, _MM_ALIGN), _round_up(n, _MM_ALIGN)
        if (mp, kp) != (m, k):
            a = F.pad(a, (0, kp - k, 0, mp - m))
        if (kp, np_) != (k, n):
            b = F.pad(b.t(), (0, kp - k, 0, np_ - n)).t()
        return torch._int_mm(a.contiguous(), b)[:m, :n]
    return torch._int_mm(a.contiguous(), b)


def _weight_layout(q, n_contracted):
    """``q``, the int8 weight of a product that contracts its first
    ``n_contracted`` axes, with the same shape and values but those axes
    fastest in memory: viewed as (k, n), it is column-major."""
    k = math.prod(q.shape[:n_contracted])
    return q.reshape(k, -1).t().contiguous().t().reshape(q.shape)


def quantize_tensor(w, reduce_axes):
    """Symmetric int8 quantization of ``w``, one scale per slice over the
    axes NOT in ``reduce_axes``.  Returns ``(q int8, scale f32)`` with the
    scale keeping the reduced dims (broadcastable)."""
    reduce_axes = tuple(reduce_axes)
    mag = w.to(torch.float32).abs()
    amax = mag.amax(dim=reduce_axes, keepdim=True) if reduce_axes else mag
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def quantize_act(x):
    """Dynamic per-example symmetric int8: ``(q, scale (N, 1, ...))``, the
    quantizer of :func:`quantize_tensor` reduced over the non-batch axes,
    so an example's output does not depend on the rest of its batch."""
    return quantize_tensor(x, reduce_axes=tuple(range(1, x.ndim)))


def quantize_dense(p):
    """``{'w', 'b'}`` (d_in, d_out) -> int8 params, per-output-column scale."""
    q, s = quantize_tensor(p["w"], reduce_axes=(0,))
    return {"w_q": _weight_layout(q, 1), "w_scale": s.reshape(-1),
            "b": p["b"].to(torch.float32)}


def dense_accumulate(xq, w_q):
    """The int32 accumulator of an int8 dense layer: ``xq`` (..., d_in)
    int8 against ``w_q`` (d_in, d_out) int8."""
    lead = xq.shape[:-1]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), w_q)
    return acc.reshape(*lead, w_q.shape[1])


def dense_apply_int8(qp, x):
    """int8 x int8 -> int32 matmul, dequantized to f32 (+ bias)."""
    xq, xs = quantize_act(x)
    acc = dense_accumulate(xq, qp["w_q"])
    return acc.to(torch.float32) * (xs * qp["w_scale"]) + qp["b"]


def quantize_conv(p):
    """OIHW conv ``{'w', 'b'}`` -> int8 kernel, per-output-channel scale."""
    q, s = quantize_tensor(p["w"], reduce_axes=(1, 2, 3))
    # channels-last: the im2col product's (kh, kw, c_in) x c_out weight is
    # then a column-major view
    return {"w_q": q.contiguous(memory_format=torch.channels_last),
            "w_scale": s.reshape(-1), "b": p["b"].to(torch.float32)}


def conv_accumulate(xq, w_q, stride=1):
    """The int32 accumulator of a SAME-padded NHWC conv: ``xq`` (N, H, W,
    C) int8 against the OIHW int8 kernel ``w_q``, as im2col and one
    :func:`int8_matmul`."""
    n, h, w, c = xq.shape
    c_out, c_in, kh, kw = w_q.shape
    h0, h1 = same_padding(h, kh, stride)
    w0, w1 = same_padding(w, kw, stride)
    xp = F.pad(xq, (0, 0, w0, w1, h0, h1))
    ho, wo = -(-h // stride), -(-w // stride)
    cols = torch.stack([
        xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
        for dy in range(kh) for dx in range(kw)
    ], dim=3)  # (N, Ho, Wo, kh*kw, C): the kernel's (kh, kw, c_in) order
    wm = w_q.permute(2, 3, 1, 0).reshape(kh * kw * c_in, c_out)
    acc = int8_matmul(cols.reshape(n * ho * wo, kh * kw * c), wm)
    return acc.reshape(n, ho, wo, c_out)


def conv_apply_int8(qp, x, stride=1):
    """int8 x int8 -> int32 NHWC SAME conv, dequantized to f32 (+ bias)."""
    xq, xs = quantize_act(x)
    acc = conv_accumulate(xq, qp["w_q"], stride)
    return acc.to(torch.float32) * (xs * qp["w_scale"]) + qp["b"]


def _x_contracted_axes(eq, x_ndim):
    """Axes of the FIRST einsum operand that are contracted away (their
    labels do not reach the output): the axes an activation scale must be
    constant over for dequantization to be exact."""
    lhs, out = eq.split("->")
    xspec = lhs.split(",")[0]
    if "..." in xspec:
        head, tail = xspec.split("...")
        if head:
            raise NotImplementedError(
                f"einsum spec {xspec!r}: put named x labels after '...'"
            )
        offset = x_ndim - len(tail)
        return tuple(offset + i for i, c in enumerate(tail) if c not in out)
    return tuple(i for i, c in enumerate(xspec) if c not in out)


def _int8_einsum(eq, xq, wq):
    """``einsum(eq, xq, wq)`` of int8 operands, accumulated exactly in int32,
    as one :func:`int8_matmul`.  It takes the form every SeqFormer equation
    has: x's trailing axes contracted against w's leading ones, in order,
    and the output x's kept axes then w's."""
    lhs, out = eq.replace("...", "").split("->")
    xspec, wspec = lhs.split(",")
    n_lead = xq.ndim - len(xspec)
    nc = sum(c not in out for c in xspec)
    kept, contracted = xspec[:len(xspec) - nc], xspec[len(xspec) - nc:]
    if not (nc and wspec[:nc] == contracted and all(c not in out for c in contracted)
            and out == kept + wspec[nc:]):
        raise NotImplementedError(
            f"int8 einsum {eq!r}: only x's trailing axes contracted against w's "
            "leading ones, in order, with the output x's kept axes then w's "
            "(e.g. 'bthk,hkd->btd')"
        )
    lead = xq.shape[:n_lead + len(kept)]
    k = math.prod(xq.shape[n_lead + len(kept):])
    acc = int8_matmul(xq.reshape(-1, k), wq.reshape(k, -1))
    return acc.reshape(*lead, *wq.shape[nc:])


def maybe_quantized_einsum(eq, x, p, dtype):
    """``einsum(eq, x, w)`` that dispatches on the weight dict: float
    (``{'w'}``) runs in ``dtype``; quantized (``{'w_q', 'w_scale'}``)
    quantizes ``x`` with one scale per output-surviving coordinate (reduced
    over exactly the contracted axes, so the scale factors out of the int32
    sum and no position's quantization depends on another's), int8-einsums
    to int32, and dequantizes by the same einsum over the keepdims scales
    (their contracted axes have size 1)."""
    if "w_q" not in p:
        return torch.einsum(eq, x, p["w"].to(dtype))
    if p["w_scale"].ndim != p["w_q"].ndim:
        raise ValueError(
            f"maybe_quantized_einsum needs keepdims weight scales "
            f"(w_scale.ndim == w_q.ndim == {p['w_q'].ndim}, got "
            f"w_scale.ndim {p['w_scale'].ndim}): this dict looks like a "
            "detector-style quantization (quantize_dense/quantize_conv "
            "flatten scales with reshape(-1) for the conv/dense apply "
            "kernels); quantize with quantize_seqformer-style keepdims "
            "scales (quantize_tensor output, unreshaped) for einsum use"
        )
    xq, xs = quantize_tensor(x, reduce_axes=_x_contracted_axes(eq, x.ndim))
    acc = _int8_einsum(eq, xq, p["w_q"])
    scale = torch.einsum(eq, xs, p["w_scale"])
    return acc.to(torch.float32) * scale


#: the SeqFormer layers quantize_seqformer takes to int8, by the last
#: component of their path, and the axes each weight's scale reduces over
_SEQFORMER_W8 = {"embed": (0,), "head": (0,), "wq": (0,), "wk": (0,), "wv": (0,),
                 "wo": (0, 1), "fc": (0,), "proj": (0,)}


def _quantize_layers(params, quantize):
    """Flat params with each layer ``quantize(prefix, {'w', 'b'})`` selects
    (a non-None result) replaced by its int8 leaves; other leaves kept."""
    out = {}
    for path, t in params.items():
        prefix, _, leaf = path.rpartition(".")
        if leaf == "w":
            q = quantize(prefix, {"w": t, "b": params[f"{prefix}.b"]})
            if q is not None:
                out.update({f"{prefix}.{k}": v for k, v in q.items()})
                continue
        out.setdefault(path, t)  # a quantized layer's bias is already in
    return out


def quantize_seqformer(params):
    """Offline PTQ of :mod:`blendjax_torch.models.seqformer` params for
    inference: attention projections, MLP, embed and head go w8 with
    KEEPDIMS per-output scales (:func:`maybe_quantized_einsum`'s
    convention); layer norms, biases (as f32) and the position table stay
    float.  The forward dispatches per weight dict, so the same model code
    serves both precisions."""
    def quantize(prefix, p):
        axes = _SEQFORMER_W8.get(prefix.rpartition(".")[2])
        if axes is None:
            return None
        q, s = quantize_tensor(p["w"], axes)
        return {"w_q": _weight_layout(q, len(axes)), "w_scale": s,
                "b": p["b"].to(torch.float32)}

    return _quantize_layers(params, quantize)


def quantize_policy(params):
    """Offline PTQ of :mod:`blendjax_torch.models.policy` params: every
    dense layer w8 (:func:`quantize_dense`, flat scales); a Gaussian
    head's ``log_std`` stays f32.  ``policy.logits`` dispatches per
    layer."""
    return _quantize_layers(params, lambda prefix, p: quantize_dense(p))


def quantize_detector(params):
    """Offline PTQ of :mod:`blendjax_torch.models.detector` params: every
    conv and dense layer w8; biases stay f32."""
    return _quantize_layers(
        params,
        lambda prefix, p: quantize_conv(p) if p["w"].ndim == 4 else quantize_dense(p))


def quantize_for_wire(params, kind):
    """Model-kind dispatch over the offline PTQ entry points; ``kind=None``
    is the identity (float wire)."""
    if kind is None:
        return params
    if kind == "seqformer":
        return quantize_seqformer(params)
    if kind == "policy":
        return quantize_policy(params)
    if kind == "detector":
        return quantize_detector(params)
    raise ValueError(
        f"unknown wire-quantization kind {kind!r}; expected one of "
        "seqformer/policy/detector or None"
    )


def detector_apply_int8(qparams, images):
    """Quantized detector forward: :func:`blendjax_torch.models.detector.
    apply` with the int8 layers injected through its ``conv_fn``/
    ``dense_fn`` seams, f32 GELU/pool/sigmoid between them.  images (N, H,
    W, C) float in [0, 1] -> (N, K, 2)."""
    from blendjax_torch.models import detector

    return detector.apply(
        qparams, images, compute_dtype=torch.float32,
        conv_fn=lambda p, x, stride: conv_apply_int8(p, x, stride=stride),
        dense_fn=dense_apply_int8,
    )
