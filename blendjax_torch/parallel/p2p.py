"""Tensor exchange between the ranks of one process group: the rotation
that stands in for the reference's ``lax.ppermute`` and the all-to-all that
stands in for its ``lax.all_to_all``.

Ranks are processes.  Ranks that share one card talk over gloo (NCCL
refuses two ranks on one device), and gloo moves CPU tensors itself.  For
CUDA tensors each op has a route, :data:`CUDA_ROUTES`, fixed by what
``probes/gloo_cuda.py`` found gloo to serve on CUDA tensors:

- ``"gloo"``: the CUDA tensor goes to gloo as it is (the all-to-all);
- ``"host"``: the op is staged through pinned host buffers (the
  rotation).  The device copies run on a side stream ordered after the
  caller's stream, gloo moves the host copy, and the received bytes go back
  to the card on the side stream, which the caller's stream then waits on.

Staging is a transport, not a fallback: the tensors the caller computes on
stay on the card, and no op changes route at run time.  :data:`counts`
counts each op's calls in this process and the calls staged through the
host, for the checks that a path really rotated (or did not).

Several tensors of one call travel as one message: they are packed into
one byte buffer, each on a 16-byte boundary, and unpacked into views of
the received buffer.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: how a CUDA tensor travels in each op (module docstring).  On torch 2.11
#: (probes/gloo_cuda.py on an H100) gloo's send/recv, isend/irecv and
#: batch_isend_irecv refuse CUDA tensors ("writev ... Bad address"), and its
#: all_to_all_single serves them (f32 and bf16, 1-16 MB)
CUDA_ROUTES = {"rotate": "host", "all_to_all": "gloo"}

#: calls of each op in this process: ``rotate`` (one call moves a list of
#: tensors, ``rotate_tensors`` counts them), ``all_to_all``, and
#: ``host_staged`` (the calls of either op staged through the host)
counts = {"rotate": 0, "rotate_tensors": 0, "all_to_all": 0, "host_staged": 0}

_ALIGN = 16
_side_streams = {}


def reset_counts():
    for key in counts:
        counts[key] = 0


def group_rank(group):
    """``(size, this rank's index)`` in ``group``."""
    return dist.get_world_size(group), dist.get_group_rank(group, dist.get_rank())


def _side_stream(device):
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


def _layout(tensors):
    """Byte offsets of each tensor in the packed buffer, and its size."""
    offsets, total = [], 0
    for t in tensors:
        offsets.append(total)
        total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    return offsets, max(total, _ALIGN)


def _pack(tensors, total, offsets):
    buf = torch.empty(total, dtype=torch.uint8, device=tensors[0].device)
    for t, off in zip(tensors, offsets):
        n = t.numel() * t.element_size()
        buf[off:off + n].copy_(t.contiguous().view(-1).view(torch.uint8))
    return buf


def _unpack(buf, like, offsets):
    out = []
    for t, off in zip(like, offsets):
        n = t.numel() * t.element_size()
        out.append(buf[off:off + n].view(t.dtype).view(t.shape))
    return out


class _Staging:
    """The host route's two copies for one call on ``device``."""

    def __init__(self, device):
        self.device = device
        self.side = _side_stream(device)
        self.caller = torch.cuda.current_stream(device)

    def to_host(self, dev):
        """A pinned host copy of ``dev``, complete when this returns."""
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        ready = torch.cuda.Event()
        ready.record(self.caller)
        with torch.cuda.stream(self.side):
            self.side.wait_event(ready)
            dev.record_stream(self.side)
            host.copy_(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.side)
        done.synchronize()
        return host

    def to_device(self, host):
        """``host`` on the card, ordered before the caller's next work."""
        with torch.cuda.stream(self.side):
            dev = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            dev.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.side)
        self.caller.wait_event(done)
        dev.record_stream(self.caller)
        return dev


class Pending:
    """An exchange in flight; :meth:`wait` returns what it received."""

    def __init__(self, works, finish):
        self._works, self._finish = works, finish

    def wait(self):
        for w in self._works:
            w.wait()
        return self._finish()


def rotate_async(tensors, group, shift=1):
    """Send ``tensors`` to the rank ``shift`` places ahead in ``group`` and
    receive the same shapes and dtypes from the rank ``shift`` places
    behind; returns a :class:`Pending`.  ``shift`` 0 (mod the group's
    size) moves nothing and counts no rotation.  Every rank of the group
    must call it with the same shift."""
    tensors = list(tensors)
    n, me = group_rank(group)
    if shift % n == 0:
        return Pending([], lambda: tensors)
    counts["rotate"] += 1
    counts["rotate_tensors"] += len(tensors)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    offsets, total = _layout(tensors)
    packed = _pack(tensors, total, offsets)
    staging = None
    if packed.is_cuda:  # CUDA_ROUTES["rotate"]: staged through the host
        counts["host_staged"] += 1
        staging = _Staging(packed.device)
        send = staging.to_host(packed)
        recv = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    else:
        send, recv = packed, torch.empty_like(packed)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                    dist.P2POp(dist.irecv, recv, src, group)])

    def finish():
        got = recv if staging is None else staging.to_device(recv)
        return _unpack(got, tensors, offsets)

    return Pending(works, finish)


def rotate(tensors, group, shift=1):
    """:func:`rotate_async`, waited on: the received tensors."""
    return rotate_async(tensors, group, shift).wait()


def all_to_all_single(flat, send_splits, recv_splits, group):
    """1-D ``flat`` cut into ``send_splits`` (elements, one count per rank of
    ``group``, in rank order), part ``j`` sent to rank ``j``; returns the
    1-D concatenation of the parts received, ``recv_splits`` from each rank
    in rank order."""
    counts["all_to_all"] += 1
    # CUDA_ROUTES["all_to_all"]: gloo takes CUDA tensors here as they are
    recv = torch.empty(sum(recv_splits), dtype=flat.dtype, device=flat.device)
    dist.all_to_all_single(recv, flat.contiguous(), list(recv_splits), list(send_splits),
                           group=group)
    return recv


class Rotate(torch.autograd.Function):
    """Differentiable :func:`rotate`: the gradients rotate back by
    ``-shift``, as ``lax.ppermute``'s transpose."""

    @staticmethod
    def forward(ctx, group, shift, *tensors):
        ctx.group, ctx.shift = group, shift
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(rotate(tensors, group, shift))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=device) if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.like)]
        return (None, None) + tuple(rotate(grads, ctx.group, -ctx.shift))


class AllToAll(torch.autograd.Function):
    """Differentiable :func:`all_to_all_single`: the gradient goes back with
    the splits swapped."""

    @staticmethod
    def forward(ctx, flat, send_splits, recv_splits, group):
        ctx.meta = (send_splits, recv_splits, group)
        return all_to_all_single(flat, send_splits, recv_splits, group)

    @staticmethod
    def backward(ctx, g):
        send, recv, group = ctx.meta
        return all_to_all_single(g.contiguous(), recv, send, group), None, None, None
