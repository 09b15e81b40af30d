"""PyTorch + CUDA port of RENI for NVIDIA Hopper (H100).

Module names follow the JAX package ``reni_tpu`` so each counterpart is easy
to find; parameters keep its nested-dict layout with weights stored
``(in, out)``. The decode path (``serve.load_decoder`` and
``cli.serve``) runs through hand-written CUDA kernels in
``kernels/csrc/siren_fwd.cu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (``utils.device``).
"""

__version__ = "0.1.0"
