"""blendjax_torch.parallel — attention across the sequence axis.  Only the
single-device reference, :func:`ring_attention.full_attention`, is ported
so far; the ring, zigzag and Ulysses schemes wait for the parallel layer
(ROADMAP Queue 1, item 7)."""
