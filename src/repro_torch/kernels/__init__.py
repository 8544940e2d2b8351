"""Hand-written CUDA kernels for Hopper (``sm_90a``) replacing the JAX
package's Pallas TPU kernels, one at a time.

Each kernel ships:

* ``csrc/<name>.cu`` — the CUDA C++ source, built with ``nvcc`` at first
  use (``_build``) and called through ``ctypes``;
* ``<name>.py``      — the wrapper: checks, output allocation, launch on
  the current stream, a launch count, and dispatch by the tensor's device;
* ``ops.py``         — public wrappers with the JAX package's signatures;
* ``ref.py``         — the plain PyTorch version the CPU path runs and the
  tests hold the kernel against.

Ported: ``dequant_u8``, ``flash_attention``, ``decode_attention`` and
``ssd_scan``, every TPU kernel of the JAX package.

The public functions live in ``ops`` and are not re-exported here, so
``repro_torch.kernels.dequant_u8`` stays the wrapper module, whose
``launches`` count a run reads.
"""
