"""PyTorch and CUDA port of the RawArray system, beside the JAX package
``repro`` it is held against.

* ``repro_torch.core``    — the RawArray format and I/O engine (a copy of
  ``repro.core``: one on-disk format, two packages);
* ``repro_torch.data``    — datasets, the host ``DataLoader`` and the
  torch ``DeviceLoader`` that decodes quantized fields on the card;
* ``repro_torch.kernels`` — hand-written CUDA kernels for Hopper;
* ``repro_torch.configs``, ``repro_torch.models`` — the model configs and
  the dense ``TransformerLM``;
* ``repro_torch.checkpoint`` — the checkpoint store and the cold start;
* ``repro_torch.serving``  — the batched ``ServeEngine``
  (``python -m repro_torch.serving``).

The package imports torch and numpy, and nothing of JAX or of ``repro``.
"""

__all__ = ["checkpoint", "configs", "core", "data", "kernels", "models", "serving"]
