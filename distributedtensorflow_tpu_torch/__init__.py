"""distributedtensorflow_tpu_torch — the PyTorch/CUDA port, first slice.

A second package beside the JAX reference ``distributedtensorflow_tpu``
with the same module layout, so every ported file has a twin it is
checked against (``tests/test_torch_*.py``).  It imports ``torch`` and
``numpy`` only — never ``jax`` nor any module of the JAX package.

This slice ports the serving path of GPT-2-small: the decode-mode model
(``models``), dense-cache ``generate``, and the paged continuous-batching
``serve.Engine``.  Its two hand-written Hopper kernels live in ``csrc/``:
the LayerNorm forward (``ops.layernorm``) and single-token decode
attention (``ops.attention``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (:func:`device.resolve_device`).
"""

__version__ = "0.1.0"
