"""The parallel layer: the ``(data, k)`` mesh as ``torch.distributed``
(``parallel/mesh.py``)."""
