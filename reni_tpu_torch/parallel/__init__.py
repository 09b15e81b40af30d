"""Multi-device layer of the port (counterpart of ``reni_tpu/parallel``): the
data x pixel x model mesh (``mesh.py``), the tensor-parallel decoder of its
model axis (``tp.py``) and multi-process runs (``multihost.py``).

One process is one rank is one device. A ``WORLD_SIZE`` of ``n_data x
n_pixel x n_model`` ranks trains one model: each rank runs on its own block
of the batch (its rows of the data axis, its slice of the pixel axis) and,
on a model axis, on its slice of the decoder's features, and the ranks sum
with ``all_reduce``. Device tensors cross ranks only through ``all_reduce``
and ``broadcast``, which gloo also carries for CUDA tensors, so the same
code runs under NCCL on a machine with a card per rank, under gloo on the
CPU, and under gloo for ranks that share one card.
"""
