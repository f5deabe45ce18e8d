"""PyTorch/CUDA port of the Symphony reproduction.

A second package beside the JAX reference ``repro``: it mirrors that
package's layout, imports ``torch`` and ``numpy`` and never ``jax`` or
anything of ``repro``.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""
