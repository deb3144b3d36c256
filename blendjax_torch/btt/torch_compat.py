"""``torch.utils.data`` adapters for the port's datasets, the port of
``blendjax.btt.torch_compat``: wrap a dataset for a ``DataLoader``::

    from blendjax_torch.btt.torch_compat import as_torch_iterable
    loader = torch.utils.data.DataLoader(as_torch_iterable(ds), batch_size=8,
                                         num_workers=4)
"""

from __future__ import annotations

import torch.utils.data as _tud


class TorchIterableAdapter(_tud.IterableDataset):
    """Presents a :class:`~blendjax_torch.btt.dataset.RemoteIterableDataset`
    to a ``DataLoader``.  Each DataLoader worker streams
    ``max_items // num_workers`` items (the dataset reads
    ``get_worker_info`` in its ``__iter__``)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __iter__(self):
        return iter(self.dataset)


class TorchMapAdapter(_tud.Dataset):
    """Presents a map-style replay (``FileDataset``, ``SingleFileDataset``)
    to a ``DataLoader``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx]


def as_torch_iterable(dataset):
    return TorchIterableAdapter(dataset)


def as_torch_map(dataset):
    return TorchMapAdapter(dataset)
