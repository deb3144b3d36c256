"""Flash attention: block-wise online-softmax attention that never holds
the (T, T) score matrix in device memory, forward and backward.

The port of ``blendjax.ops.flash_attention``.  Three passes, each with a
plain PyTorch version (what a CPU tensor gets) and a hand-written CUDA
kernel for Hopper (what a CUDA tensor gets):

- forward: :func:`flash_fwd_plain`, :func:`flash_fwd_cuda`;
- dQ: :func:`flash_dq_plain`, :func:`flash_dq_cuda`;
- dK/dV: :func:`flash_dkv_plain`, :func:`flash_dkv_cuda`.

Each wrapper chooses its kernel by the inputs' dtype (:func:`kernel_route`):
bf16 goes to the tensor-core kernels of ``csrc/flash_fwd_tc.cu`` and
``csrc/flash_bwd_tc.cu`` (wgmma, TMA, P and dS as bf16 hi + lo pairs), f32
to the exact-f32 CUDA-core kernels of ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``.

They replace the Pallas TPU kernels ``_kernel``, ``_dq_kernel`` and
``_dkv_kernel``.  The dispatchers :func:`_flash_fwd_impl`, :func:`_dq_pass`
and :func:`_dkv_pass` send a CUDA tensor to the kernel (a failed build or
launch raises; there is no fallback) and a CPU tensor to the plain pass.
:class:`FlashAttention` is the autograd function that replaces the
reference's ``custom_vjp``.

The passes work on flat ``(batch*heads, T, D)`` tensors, as the
reference's do.  Under grouped-query attention k/v carry fewer heads and
each q head reads its group's kv head (:func:`_kv_head_map`); the dK/dV
pass then returns f32 partials per q head, which :class:`FlashAttention`
folds onto the shared kv head.

Semantics are the reference's: scores in f32 times the scale, masked
entries set to -1e30 after the scale, a running max that starts at -1e30,
``safe = where(l == 0, 1, l)`` and ``lse = m + log(safe)`` — a row that
sees no column gives O = 0 and lse = -1e30.  A masked entry's probability
is exactly 0.  ``block_q``/``block_kv`` keep their contract (validation,
the error when T does not divide them); the kernels pick their own 64-row
tiles, so results do not depend on the blocks.
"""

from __future__ import annotations

import ctypes

import torch

_NEG = -1e30
_KINDS = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the CUDA kernels are instantiated for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
#: the kernels' route by input dtype: "tc" = tensor cores
#: (``csrc/flash_{fwd,bwd}_tc.cu``), "f32" = f32 FMAs
#: (``csrc/flash_{fwd,bwd}.cu``)
ROUTES = {torch.bfloat16: "tc", torch.float32: "f32"}


def _default_scale(scale, d):
    return scale if scale is not None else 1.0 / (d ** 0.5)


def flash_block_size(seq_len):
    """Largest flash tile dividing ``seq_len`` (or ``seq_len`` itself):
    the reference's tile-selection policy."""
    return next((b for b in (128, 64, 32) if seq_len % b == 0), seq_len)


def _kv_window_steps(num_kv, block_q, block_kv, window):
    """KV blocks one q block can see under a sliding window (the span of
    ``block_q + window - 1`` positions at worst-case alignment)."""
    span = block_q + window - 1
    return min(num_kv, (span - 2) // block_kv + 2)


def _kv_base(i, block_q, block_kv, window, q_offset=0):
    """First KV block visible to q block ``i`` under a window."""
    return max(0, (i * block_q + q_offset - (window - 1)) // block_kv)


def _q_window_steps(num_q, block_q, block_kv, window):
    """Q blocks that can see one KV block under a sliding window."""
    span = block_kv + window - 1
    return min(num_q, (span - 2) // block_q + 2)


def _q_base(j, block_q, block_kv, window, q_offset=0):
    """First Q block that can see KV block ``j``."""
    del window
    return max(0, (j * block_kv - q_offset) // block_q)


def _kv_head_map(h_q, h_kv):
    """Flat ``b*h`` index of the KV head serving flat q head ``bh``, or
    None when the head counts match: ``h_q // h_kv`` consecutive q heads
    share one kv head."""
    if h_q == h_kv:
        return None
    g = h_q // h_kv
    return lambda bh: (bh // h_q) * h_kv + (bh % h_q) // g


def _check_blocks(t, block, name):
    if t % block:
        raise ValueError(
            f"sequence length {t} must divide {name}={block} "
            "(pad upstream or pick smaller blocks)"
        )


def _check_window(causal, window):
    if window is None:
        return
    if not causal:
        raise ValueError("window (sliding-window attention) requires causal=True")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _check_window_overshoot(window, q_offset, tq, tk):
    """The reference's refusal: with ``q_offset == 0`` a window needs
    ``Tk == Tq`` (its kernels rely on the causal bound to kill the
    clamped last KV block, which holds only for same-length pairs)."""
    if window is not None and not q_offset and tk != tq:
        raise ValueError(
            f"windowed attention with q_offset=0 requires Tk == Tq (got "
            f"Tq={tq}, Tk={tk}): the overshoot clamp relies on the causal "
            "bound to kill the last KV block, which only holds for "
            "same-length pairs; pass the pair's static q_offset"
        )


def _check_heads(h, h_kv, h_v):
    if h % h_kv:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {h_kv} (GQA)")
    if h_v != h_kv:
        raise ValueError(
            f"k has {h_kv} heads but v has {h_v} — the shared "
            "KV head map would silently read wrong v blocks"
        )


def _flat(x):
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def _unflat(xf, b, h):
    bh, t, d = xf.shape
    return xf.reshape(b, h, t, d).permute(0, 2, 1, 3)


# -- plain passes --------------------------------------------------------------


def _expand_kv(xf, bh, heads):
    """k/v rows read by each flat q head (the GQA head map as a gather)."""
    if not heads or heads[0] == heads[1]:
        return xf
    khm = _kv_head_map(*heads)
    return xf[torch.tensor([khm(i) for i in range(bh)], device=xf.device)]


def _visible(tq, tk, causal, window, q_offset, device):
    """(Tq, Tk) bool mask of visible entries, or None when nothing is
    masked (non-causal)."""
    if not causal:
        return None
    rows = q_offset + torch.arange(tq, device=device)[:, None]
    cols = torch.arange(tk, device=device)[None, :]
    keep = cols <= rows
    if window is not None:
        keep &= cols > rows - window
    return keep


def _probs(qf, kf, scale, keep, lse=None):
    """f32 scores masked after the scale; returns (p, m) with the softmax
    numerators p = exp(s - m) for m = rowmax (floored at -1e30), or, with
    ``lse``, p = exp(s - lse) and m None.  Masked entries give p = 0."""
    s = torch.matmul(qf.float(), kf.float().transpose(-1, -2)) * scale
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, _NEG))
    if lse is None:
        m = s.amax(-1, keepdim=True).clamp_min(_NEG)
        p = torch.exp(s - m)
    else:
        m = None
        p = torch.exp(s - lse)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    return p, m


def flash_fwd_plain(qf, kf, vf, causal, scale, out_dtype=None, window=None,
                    q_offset=0, heads=None):
    """What ``_kernel`` computes, in plain PyTorch: flat q (BH, Tq, D),
    k/v (BH_kv, Tk, D) -> (O (BH, Tq, D) in ``out_dtype`` or q's dtype,
    lse (BH, Tq, 1) f32)."""
    bh, tq, _ = qf.shape
    keep = _visible(tq, kf.shape[1], causal, window, q_offset, qf.device)
    p, m = _probs(qf, _expand_kv(kf, bh, heads), scale, keep)
    l = p.sum(-1, keepdim=True)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    of = torch.matmul(p, _expand_kv(vf, bh, heads).float()) / safe
    return of.to(out_dtype or qf.dtype), m + torch.log(safe)


def _grad_parts(qf, kf, vf, dof, lse, delta, causal, scale, window, q_offset, heads):
    bh, tq, _ = qf.shape
    keep = _visible(tq, kf.shape[1], causal, window, q_offset, qf.device)
    k32 = _expand_kv(kf, bh, heads).float()
    v32 = _expand_kv(vf, bh, heads).float()
    p, _ = _probs(qf, k32, scale, keep, lse=lse.float())
    do32 = dof.float()
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    ds = p * (dp - delta.float()) * scale
    return p, ds, k32, do32


def flash_dq_plain(qf, kf, vf, dof, lse, delta, causal, scale, out_dtype=None,
                   window=None, q_offset=0, heads=None):
    """What ``_dq_kernel`` computes: dQ = dS K with P recomputed from
    ``lse`` and dS = P * (dP - delta) * scale, in ``out_dtype`` or q's."""
    _, ds, k32, _ = _grad_parts(qf, kf, vf, dof, lse, delta, causal, scale, window,
                                q_offset, heads)
    return torch.matmul(ds, k32).to(out_dtype or qf.dtype)


def flash_dkv_plain(qf, kf, vf, dof, lse, delta, causal, scale, out_dtype=None,
                    window=None, q_offset=0, heads=None):
    """What ``_dkv_kernel`` computes: dK = dS^T Q and dV = P^T dO per q
    head, (BH, Tk, D) each, in ``out_dtype`` or k's / v's dtype."""
    p, ds, _, do32 = _grad_parts(qf, kf, vf, dof, lse, delta, causal, scale, window,
                                 q_offset, heads)
    dk = torch.matmul(ds.transpose(-1, -2), qf.float())
    dv = torch.matmul(p.transpose(-1, -2), do32)
    return dk.to(out_dtype or kf.dtype), dv.to(out_dtype or vf.dtype)


# -- CUDA kernels ----------------------------------------------------------------


def _library():
    from blendjax_torch.ops._build import load_library

    lib = load_library()
    if not hasattr(lib, "_bjx_typed"):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [i, i, i, i, i, i, f, i, i, i, i, i, p]
        lib.bjx_flash_fwd.argtypes = [p] * 5 + shape
        lib.bjx_flash_fwd_tc.argtypes = [p] * 5 + shape
        lib.bjx_flash_dq.argtypes = [p] * 7 + shape
        lib.bjx_flash_dkv.argtypes = [p] * 8 + shape
        lib.bjx_flash_dq_tc.argtypes = [p] * 7 + shape
        lib.bjx_flash_dkv_tc.argtypes = [p] * 8 + shape
        for fn in (lib.bjx_flash_fwd, lib.bjx_flash_dq, lib.bjx_flash_dkv,
                   lib.bjx_flash_fwd_tc, lib.bjx_flash_dq_tc, lib.bjx_flash_dkv_tc):
            fn.restype = ctypes.c_int
        lib._bjx_typed = True
    return lib


def _kernel_args(name, qf, kf, vf, out_dtype, heads, rest=()):
    """Validate the kernels' inputs; returns (in kind, out kind, h_q, h_kv)."""
    tensors = (qf, kf, vf) + tuple(rest)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        raise ValueError(f"{name} needs CUDA tensors")
    if any(t.device != qf.device for t in tensors):
        raise ValueError(f"{name} needs all tensors on one device")
    if qf.dim() != 3 or any(t.shape != qf.shape for t in rest):
        raise ValueError(f"{name} needs flat (BH, T, D) q and dO of one shape")
    if qf.dtype not in _KINDS or any(t.dtype != qf.dtype for t in tensors):
        raise ValueError(
            f"{name} needs q, k, v (and dO) all float32 or all bfloat16, got "
            f"{sorted({str(t.dtype) for t in tensors})}"
        )
    if out_dtype not in _KINDS:
        raise ValueError(f"{name} outputs float32 or bfloat16, not {out_dtype}")
    d = qf.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} has no kernel (one of {KERNEL_HEAD_DIMS})")
    if kf.shape[-1] != d or vf.shape != kf.shape:
        raise ValueError(f"{name}: k {tuple(kf.shape)} / v {tuple(vf.shape)} do not match q")
    h_q, h_kv = heads if heads else (1, 1)
    if h_q % h_kv or qf.shape[0] % h_q or qf.shape[0] * h_kv != kf.shape[0] * h_q:
        raise ValueError(f"{name}: {qf.shape[0]} q rows and {kf.shape[0]} kv rows "
                         f"do not fit heads {heads}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    return _KINDS[qf.dtype], _KINDS[out_dtype], h_q, h_kv


def _problem(qf, kf, h_q, h_kv, causal, scale, window, q_offset):
    bh, tq, d = qf.shape
    return [bh, h_q, h_kv, tq, kf.shape[1], d, float(scale), int(bool(causal)),
            int(window or 0), int(q_offset)]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def kernel_route(dtype, d, route=None):
    """The kernel route the forward, dQ and dK/dV wrappers take for inputs
    of ``dtype`` at head dim ``d``: by default "tc" for bfloat16 and "f32"
    for float32, a dispatch on the dtype, not a fallback (what has no
    kernel raises).  ``route="f32"`` asks for the CUDA-core kernels with
    bf16 inputs too (they widen them on load), so that one process can time
    both."""
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel (one of {KERNEL_HEAD_DIMS})")
    if dtype not in ROUTES:
        raise ValueError(f"the flash kernels take float32 or bfloat16, not {dtype}")
    route = route or ROUTES[dtype]
    if route not in ("tc", "f32"):
        raise ValueError(f"kernel route {route!r} is not 'tc' or 'f32'")
    if route == "tc" and dtype != torch.bfloat16:
        raise ValueError(f"the tensor-core route takes bfloat16 inputs, not {dtype}")
    return route


def _tma_ready(t):
    """``t`` with a 16-byte aligned base, as TMA reads it: a copy where a
    view starts off the allocation's alignment."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rows_f32(x, like):
    """lse/delta as contiguous f32 (BH, T) on q's device for the kernels."""
    bh, t, _ = like.shape
    if x.dtype != torch.float32 or x.device != like.device or x.numel() != bh * t:
        raise ValueError(f"lse/delta must be float32 with {bh * t} values on {like.device}")
    return x.reshape(bh, t).contiguous()


def _entry(name, tensors, route):
    """The C entry point of pass ``name`` ("fwd", "dq" or "dkv") on the
    route of :func:`kernel_route`, the route, and the input ``tensors`` (q
    first) as it reads them."""
    qf = tensors[0]
    route = kernel_route(qf.dtype, qf.shape[-1], route)
    if route == "f32":
        return getattr(_library(), f"bjx_flash_{name}"), route, tensors
    tensors = tuple(_tma_ready(t) for t in tensors)
    return getattr(_library(), f"bjx_flash_{name}_tc"), route, tensors


def flash_fwd_cuda(qf, kf, vf, causal, scale, out_dtype=None, window=None,
                   q_offset=0, heads=None, route=None):
    """Launch K2 (the forward) on the route of :func:`kernel_route`
    (``route`` None: by dtype); same contract as :func:`flash_fwd_plain`.
    :attr:`launches` counts launches, and :attr:`launches_by_route` each
    route's."""
    out_dtype = out_dtype or qf.dtype
    kin, kout, h_q, h_kv = _kernel_args("flash_fwd_cuda", qf, kf, vf, out_dtype, heads)
    bh, tq, d = qf.shape
    of = torch.empty((bh, tq, d), dtype=out_dtype, device=qf.device)
    lse = torch.empty((bh, tq, 1), dtype=torch.float32, device=qf.device)
    entry, route, (qf, kf, vf) = _entry("fwd", (qf, kf, vf), route)
    with torch.cuda.device(qf.device):
        err = entry(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), of.data_ptr(), lse.data_ptr(),
            *_problem(qf, kf, h_q, h_kv, causal, scale, window, q_offset),
            kin, kout, _stream(qf))
    _raise_on(err, "flash_fwd")
    flash_fwd_cuda.launches += 1
    flash_fwd_cuda.launches_by_route[route] += 1
    return of, lse


def flash_dq_cuda(qf, kf, vf, dof, lse, delta, causal, scale, out_dtype=None,
                  window=None, q_offset=0, heads=None, route=None):
    """Launch K3 (dQ) on the route of :func:`kernel_route` (``route``
    None: by dtype); same contract as :func:`flash_dq_plain`.
    :attr:`launches` counts launches, and :attr:`launches_by_route` each
    route's."""
    out_dtype = out_dtype or qf.dtype
    kin, kout, h_q, h_kv = _kernel_args("flash_dq_cuda", qf, kf, vf, out_dtype, heads,
                                        (dof,))
    lse, delta = _rows_f32(lse, qf), _rows_f32(delta, qf)
    dq = torch.empty(qf.shape, dtype=out_dtype, device=qf.device)
    entry, route, (qf, kf, vf, dof) = _entry("dq", (qf, kf, vf, dof), route)
    with torch.cuda.device(qf.device):
        err = entry(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(),
            *_problem(qf, kf, h_q, h_kv, causal, scale, window, q_offset),
            kin, kout, _stream(qf))
    _raise_on(err, "flash_dq")
    flash_dq_cuda.launches += 1
    flash_dq_cuda.launches_by_route[route] += 1
    return dq


def flash_dkv_cuda(qf, kf, vf, dof, lse, delta, causal, scale, out_dtype=None,
                   window=None, q_offset=0, heads=None, route=None):
    """Launch K4 (dK/dV) on the route of :func:`kernel_route` (``route``
    None: by dtype); same contract as :func:`flash_dkv_plain`.
    :attr:`launches` counts launches, and :attr:`launches_by_route` each
    route's."""
    out_dtype = out_dtype or kf.dtype
    kin, kout, h_q, h_kv = _kernel_args("flash_dkv_cuda", qf, kf, vf, out_dtype, heads,
                                        (dof,))
    bh, _, d = qf.shape
    lse, delta = _rows_f32(lse, qf), _rows_f32(delta, qf)
    dk = torch.empty((bh, kf.shape[1], d), dtype=out_dtype, device=qf.device)
    dv = torch.empty_like(dk)
    entry, route, (qf, kf, vf, dof) = _entry("dkv", (qf, kf, vf, dof), route)
    with torch.cuda.device(qf.device):
        err = entry(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_problem(qf, kf, h_q, h_kv, causal, scale, window, q_offset),
            kin, kout, _stream(qf))
    _raise_on(err, "flash_dkv")
    flash_dkv_cuda.launches += 1
    flash_dkv_cuda.launches_by_route[route] += 1
    return dk, dv


for _fn in (flash_fwd_cuda, flash_dq_cuda, flash_dkv_cuda):
    _fn.launches = 0
    _fn.launches_by_route = {route: 0 for route in ROUTES.values()}
del _fn


# -- dispatchers (the reference's entry points) -----------------------------------


def _flash_fwd_impl(q, k, v, causal, scale, block_q, block_kv, out_dtype=None,
                    window=None, q_offset=0):
    """Returns (out (B,T,H,D), flat residuals (qf, kf, vf, of, lse)).

    ``out_dtype`` overrides the output dtype (default: q's); ``q_offset``
    is the global position of q row 0 minus kv row 0, and k/v may then
    have another length than q.  k/v may carry fewer heads than q (GQA)."""
    b, t, h, _ = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    _check_blocks(t, block_q, "block_q")
    _check_blocks(tk, block_kv, "block_kv")
    _check_window_overshoot(window, q_offset, t, tk)
    _check_heads(h, h_kv, v.shape[2])
    qf, kf, vf = _flat(q), _flat(k), _flat(v)
    heads = (h, h_kv) if h != h_kv else None
    fwd = flash_fwd_cuda if q.is_cuda else flash_fwd_plain
    of, lse = fwd(qf, kf, vf, causal, scale, out_dtype=out_dtype, window=window,
                  q_offset=q_offset, heads=heads)
    return _unflat(of, b, h), (qf, kf, vf, of, lse)


def _dq_pass(qf, kf, vf, dof, lse, delta, causal, scale, block_q, block_kv,
             out_dtype=None, window=None, q_offset=0, heads=None):
    """dQ for one (Tq, Tk) pair of flat tensors."""
    tq, tk = qf.shape[1], kf.shape[1]
    _check_blocks(tq, block_q, "block_q")
    _check_blocks(tk, block_kv, "block_kv")
    _check_window_overshoot(window, q_offset, tq, tk)
    dq = flash_dq_cuda if qf.is_cuda else flash_dq_plain
    return dq(qf, kf, vf, dof, lse, delta, causal, scale, out_dtype=out_dtype,
              window=window, q_offset=q_offset, heads=heads)


def _dkv_pass(qf, kf, vf, dof, lse, delta, causal, scale, block_q, block_kv,
              out_dtype=None, window=None, q_offset=0, heads=None):
    """dK/dV for one (Tq, Tk) pair; under GQA (``heads=(h_q, h_kv)``) the
    outputs stay per q head and the caller group-sums them."""
    tq, tk = qf.shape[1], kf.shape[1]
    _check_blocks(tq, block_q, "block_q")
    _check_blocks(tk, block_kv, "block_kv")
    _check_window_overshoot(window, q_offset, tq, tk)
    dkv = flash_dkv_cuda if qf.is_cuda else flash_dkv_plain
    return dkv(qf, kf, vf, dof, lse, delta, causal, scale, out_dtype=out_dtype,
               window=window, q_offset=q_offset, heads=heads)


class FlashAttention(torch.autograd.Function):
    """q/k/v (B, T, H, D) -> (B, T, H, D); the backward reuses the O and
    lse the forward saved, runs the dQ and dK/dV passes, and under GQA
    folds the f32 per-q-head partials onto each shared kv head."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_kv, window):
        _check_window(causal, window)
        scale_v = _default_scale(scale, q.shape[-1])
        out, (qf, kf, vf, of, lse) = _flash_fwd_impl(
            q, k, v, causal, scale_v, block_q, block_kv, window=window)
        ctx.save_for_backward(qf, kf, vf, of, lse)
        ctx.meta = (q.shape, causal, scale_v, block_q, block_kv, window)
        return out

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, of, lse = ctx.saved_tensors
        (b, t, h, d), causal, scale, block_q, block_kv, window = ctx.meta
        h_kv = kf.shape[0] // b
        heads = (h, h_kv) if h_kv != h else None
        dof = _flat(g.to(qf.dtype))
        # delta = rowsum(dO * O) in f32: the softmax-jacobian correction
        delta = (dof.float() * of.float()).sum(-1, keepdim=True)
        dq = _dq_pass(qf, kf, vf, dof, lse, delta, causal, scale, block_q, block_kv,
                      window=window, heads=heads)
        dk, dv = _dkv_pass(qf, kf, vf, dof, lse, delta, causal, scale, block_q,
                           block_kv, window=window, heads=heads,
                           out_dtype=torch.float32 if heads else None)
        if heads is not None:
            tk = kf.shape[1]

            def fold(x, dt):
                return x.reshape(b, h_kv, h // h_kv, tk, d).sum(2).reshape(-1, tk, d).to(dt)

            dk, dv = fold(dk, kf.dtype), fold(dv, vf.dtype)
        return (_unflat(dq, b, h), _unflat(dk, b, h_kv), _unflat(dv, b, h_kv),
                None, None, None, None, None)


def flash_attention(q, k, v, causal=False, scale=None, block_q=128, block_kv=128,
                    window=None):
    """Fused block-wise attention with the contract of ``full_attention``:
    q/k/v (B, T, H, D) -> (B, T, H, D).  ``T`` must divide by both block
    sizes.  k/v may carry fewer heads than q (GQA, ``H % H_kv == 0``).
    ``window=W`` (causal only) is sliding-window attention: each query sees
    its own and the previous ``W - 1`` positions."""
    return FlashAttention.apply(q, k, v, causal, scale, block_q, block_kv, window)


def make_flash_attention(causal=True, block_q=128, block_kv=128, window=None):
    """``attn_fn`` closure for :func:`blendjax_torch.models.seqformer.apply`.

    ``block_q``/``block_kv`` may be ``'auto'``: the tile is then sized per
    call by :func:`flash_block_size`, so any 32-multiple length (or any
    length up to 128) works; longer ragged lengths are rejected."""
    _check_window(causal, window)

    def attn(q, k, v):
        t = q.shape[1]
        auto = flash_block_size(t)
        if (block_q == "auto" or block_kv == "auto") and auto == t and t > 128:
            raise ValueError(
                f"sequence length {t} has no flash tile (not a multiple "
                "of 32 and too long for a single tile); pad to a "
                "32-multiple upstream"
            )
        bq = auto if block_q == "auto" else block_q
        bkv = auto if block_kv == "auto" else block_kv
        return flash_attention(q, k, v, causal, None, bq, bkv, window)

    return attn
